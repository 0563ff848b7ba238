"""Where the time of rows 11 and 13's TMA-ring GEMV goes, on the H100.

    python -m uniaudio2_tpu_torch.probes.stream_breakdown

Builds `csrc/gemv_int4_sweep.cu` (row 13's forms of
`csrc/gemv_int4_stream.cuh`) four times into `build/stream_breakdown/`,
from copies of `csrc/` with parts of the kernel taken out, and times form
0 of each at the row's shapes and M = 1 and 16:

* ``ring``: the kernel as it is;
* ``no-arith``: the consumers wait for each box and free it, and do no
  step (the ring, the staging, the reductions and the epilogue remain);
* ``no-stage``: x is not staged (the products read what shared memory
  holds);
* ``no-arith-no-stage``: the ring, the reductions and the epilogue alone.

The two cut variants give wrong outputs; only their times are read. Each
time is taken twice: after the L2 is flushed by writing a 256 MB buffer
(`FlushedTimer`, every phase-3 and probe time: the L2 then holds dirty
lines, which the kernel's reads evict) and after it is flushed by reading
it (clean lines). Beside them: the timer's floor (one launch of a
one-element fill), one ``copy_`` of as many bytes as the weights (read
and written) and one ``torch._weight_int4pack_mm`` call. One JSON line per
(shape, M); the first line holds the floors and the copies.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, int4_sweep, quant

OUT = _cuda.BUILD_DIR.parent / "stream_breakdown"
SHAPES = ((256, 512), (3072, 5120), (3072, 8192))
ROWS = (1, 16)
_ARITH = ("        if (i >= n_rows) break;", "        if (true) break;")
_STAGE = ("    if (K % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0) {",
          "    if (false) {")
_STAGE_SCALAR = ("      for (int i = tid; i < xw; i += CONSUMERS) {",
                 "      for (int i = tid; i < 0; i += CONSUMERS) {")
VARIANTS = {"ring": (), "no-arith": (_ARITH,),
            "no-stage": (_STAGE, _STAGE_SCALAR),
            "no-arith-no-stage": (_ARITH, _STAGE, _STAGE_SCALAR)}


def build() -> dict:
    """Compile each variant's `gemv_int4_sweep.cu` in parallel; returns
    {variant: library path}."""
    if OUT.exists():
        shutil.rmtree(OUT)
    procs = {}
    for name, edits in VARIANTS.items():
        src = OUT / name
        shutil.copytree(_cuda.CSRC, src)
        header = src / "gemv_int4_stream.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"stream_breakdown: {name}: the header no "
                                   f"longer holds {old.strip()!r}")
            text = text.replace(old, new)
        header.write_text(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
               str(src / "lib.so"), str(src / "gemv_int4_sweep.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"stream_breakdown: nvcc failed for {name}:\n{log}")
        libs[name] = OUT / name / "lib.so"
    return libs


def main(device: str = "cuda"):
    """Run the breakdown; print and return its JSON lines."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card, int4_tinygemm

    class CleanTimer(FlushedTimer):
        """`FlushedTimer` with the 256 MB buffer read instead of written."""

        def __call__(self, fn, reps: int = 15) -> float:
            fn()
            pairs = []
            for _ in range(reps):
                self.flush.view(torch.int32).sum()
                torch.cuda._sleep(self.SPIN_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
            return statistics.median(s.elapsed_time(e) for s, e in pairs)

    dev = torch.device(device)
    timers = {"dirty": FlushedTimer(dev), "clean": CleanTimer(dev)}
    libs = {}
    for name, path in build().items():
        lib = ctypes.CDLL(str(path))
        lib.ua2_gemv_int4_sweep.argtypes = _cuda._SIGNATURES["ua2_gemv_int4_sweep"]
        lib.ua2_gemv_int4_sweep.restype = ctypes.c_int
        libs[name] = lib
    sms = quant._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    tiny = torch.zeros(1, device=dev)
    head = {"probe": "stream_breakdown", "card": card()}
    for tname, timer in timers.items():
        head[f"floor_us_{tname}"] = timer(lambda: tiny.zero_()) * 1e3
        for k, n in SHAPES[1:]:
            src = torch.empty(k * n // 2, dtype=torch.int8, device=dev)
            dst = torch.empty_like(src)
            head[f"copy_us_{tname}_{k}x{n}"] = timer(lambda: dst.copy_(src)) * 1e3
    print(json.dumps(head), flush=True)
    lines = [head]
    form = int4_sweep.FORMS[int4_sweep.PRODUCTION]
    for k, n in SHAPES:
        w = quant.quantize4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        lib_args = int4_tinygemm(w)
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            splits, span = int4_stream.stream_plan(m, k, n, sms, form)
            line = {"K": k, "N": n, "M": m, "plan": [splits, span], "us": {}}
            for name, lib in libs.items():
                def run(lib=lib):
                    _cuda.check(lib.ua2_gemv_int4_sweep(
                        int4_sweep.PRODUCTION, _cuda.ptr(x), _cuda.ptr(w.values),
                        _cuda.ptr(w.scale), _cuda.ptr(out), m, k, n,
                        w.values.shape[1], splits, span, _cuda.stream_of(x)),
                        "ua2_gemv_int4_sweep")
                for tname, timer in timers.items():
                    line["us"][f"{name} {tname}"] = timer(run) * 1e3
            for tname, timer in timers.items():
                line["us"][f"library {tname}"] = timer(
                    lambda: torch._weight_int4pack_mm(x, *lib_args)) * 1e3
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
