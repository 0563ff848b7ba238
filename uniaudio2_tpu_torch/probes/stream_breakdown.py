"""Where the time of the TMA-ring GEMV (rows 11-14) goes, on the H100.

    python -m uniaudio2_tpu_torch.probes.stream_breakdown

Builds `csrc/gemv_int4_sweep.cu` (row 13's forms of
`csrc/gemv_int4_stream.cuh`) and `csrc/gemv_int8_splitk.cu` (row 12's int8
form of it) four times each into `build/stream_breakdown/`, from copies
of `csrc/` with parts of the kernel taken out, and times form 0 of row 13
at its shapes and M = 1 and 16, and row 12's ring at (3072, 8192) and at
the text lm_head's (3072, 128256), M = 1:

* ``ring``: the kernel as it is;
* ``no-arith``: the consumers wait for each box and free it, and do no
  step (the ring, the staging, the reductions and the epilogue remain);
* ``no-stage``: x is not staged (the products read what shared memory
  holds);
* ``no-arith-no-stage``: the ring, the reductions and the epilogue alone.

The cut variants give wrong outputs; only their times are read. Each
time is taken twice: after the L2 is flushed by writing a 256 MB buffer
(`FlushedTimer`, every phase-3 and probe time: the L2 then holds dirty
lines, which the kernel's reads evict) and after it is flushed by reading
it (clean lines). Beside them: the timer's floor (one launch of a
one-element fill), one ``copy_`` of as many bytes as the weights (read
and written) and the library's call (``torch._weight_int4pack_mm``, or
``torch._weight_int8pack_mm`` with bf16 scales); for int8 also row 12's
two-pass first design at (3072, 8192), and the served lm_head GEMV (`quant.int8_matmul`, the split-K kernel's wide-N
instance) at (3072, 128256). One JSON line per (layout, shape, M); the
first line holds the floors and the int4 copies.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from uniaudio2_tpu_torch.ops import (
    _cuda, int4_stream, int4_sweep, quant, splitk_gemv,
)

OUT = _cuda.BUILD_DIR.parent / "stream_breakdown"
SHAPES = ((256, 512), (3072, 5120), (3072, 8192))
ROWS = (1, 16)
INT8_SHAPES = ((3072, 8192), (3072, 128256))    # row 12's, the text lm_head
SOURCES = {"int4": "gemv_int4_sweep.cu", "int8": "gemv_int8_splitk.cu"}
_ARITH = ("        if (i >= n_rows) break;", "        if (true) break;")
_STAGE = ("    if (K % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0) {",
          "    if (false) {")
_STAGE_SCALAR = ("      for (int i = tid; i < xw; i += CONSUMERS) {",
                 "      for (int i = tid; i < 0; i += CONSUMERS) {")
VARIANTS = {"ring": (), "no-arith": (_ARITH,),
            "no-stage": (_STAGE, _STAGE_SCALAR),
            "no-arith-no-stage": (_ARITH, _STAGE, _STAGE_SCALAR)}


def build() -> dict:
    """Compile each variant's `gemv_int4_sweep.cu` and `gemv_int8_splitk.cu`
    in parallel; returns {(variant, "int4" or "int8"): library path}."""
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
        for kind, source in SOURCES.items():
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                   str(src / f"lib_{kind}.so"), str(src / source)]
            procs[(name, kind)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (name, kind), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"stream_breakdown: nvcc failed for {name} "
                               f"{kind}:\n{log}")
        libs[(name, kind)] = OUT / name / f"lib_{kind}.so"
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
    libs, libs8 = {}, {}
    for (name, kind), path in build().items():
        lib = ctypes.CDLL(str(path))
        fns = (("ua2_gemv_int4_sweep",) if kind == "int4" else
               ("ua2_gemv_int8_splitk", "ua2_gemv_int8_splitk_twopass"))
        for fn in fns:
            getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        (libs if kind == "int4" else libs8)[name] = lib
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
    for k, n in INT8_SHAPES:
        lines.append(int8_line(libs8, timers, k, n, sms, gen, dev))
    return lines


def int8_line(libs, timers, k, n, sms, gen, dev):
    """Row 12's ring in every variant at (k, n), M = 1, beside a ``copy_``
    of the weights, the library and (at (3072, 8192)) the two-pass first
    design, or (at the lm_head) the served wide-N GEMV; returns the printed
    line."""
    from uniaudio2_tpu_torch.probes import bound_us

    w = quant.quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    x = torch.randn((1, k), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((1, n), dtype=torch.bfloat16, device=dev)
    ldw = w.values.shape[1]

    splits, span = int4_stream.stream_plan(1, k, n, sms, splitk_gemv.FORM,
                                           quant.LAYOUT_INT8)

    def ring(lib):
        def run():
            _cuda.check(lib.ua2_gemv_int8_splitk(
                _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale),
                _cuda.ptr(out), 1, k, n, ldw, splits, span,
                _cuda.stream_of(x)), "ua2_gemv_int8_splitk")
        return run

    line = {"layout": "int8", "K": k, "N": n, "M": 1, "plan": [splits, span],
            "bound_us": bound_us(k * n + 2 * k + 6 * n, 2 * k * n), "us": {}}
    runs = {name: ring(lib) for name, lib in libs.items()}
    src = torch.empty(k * n, dtype=torch.int8, device=dev)
    dst = torch.empty_like(src)
    runs["copy"] = lambda: dst.copy_(src)
    w_lib = w.values[:, :n].T.contiguous()
    s_lib = w.scale.to(torch.bfloat16)
    runs["library"] = lambda: torch._weight_int8pack_mm(x, w_lib, s_lib)
    if n > 8192:
        runs["int8_matmul wide-N"] = lambda: quant.int8_matmul(x, w.values,
                                                               w.scale)
    else:
        two = libs["ring"]
        parts, chunk = splitk_gemv.plan(k, n)
        part = torch.empty((parts, -(-n // splitk_gemv.TILE) * splitk_gemv.TILE),
                           dtype=torch.float32, device=dev)

        def twopass():
            _cuda.check(two.ua2_gemv_int8_splitk_twopass(
                _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale),
                _cuda.ptr(part), _cuda.ptr(out), k, n, ldw, parts, chunk,
                _cuda.stream_of(x)), "ua2_gemv_int8_splitk_twopass")
        runs["two-pass"] = twopass
    for name, run in runs.items():
        for tname, timer in timers.items():
            line["us"][f"{name} {tname}"] = timer(run) * 1e3
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
