"""Rows 1, 5 and 6's split-K GEMVs and rows 11 and 13's TMA ring through
two builds of the kernel library in one process, on the H100: this
checkout's and another checkout's (for instance the parent commit,
unpacked with ``git archive`` into an ignored directory), so that a change
to `csrc/gemv_int4_splitk.cuh` or `csrc/gemv_int4_stream.cuh` is timed
against its parent on the same card, in the same process, on the same
tensors.

    python -m uniaudio2_tpu_torch.probes.splitk_ab OTHER_CHECKOUT [FORM ...]

The other checkout builds its own library (in its own ``build/``) in a
subprocess, which also reports its C entry points' argument counts (an
older checkout's K-split entry point takes no scratch pointer for the tile
kernel; a form whose entry point there takes no plan at all, as int8's
before it had a split-K instance, is left out).
The forms are the split-K kernel's (`gemv_splitk_sweep.FORMS`, at each
decode shape of its `CASES` and M = 1, 2 and 16, on `quant.gemv_plan`) and
the ring's default form (`RING`: row 11's interleaved entry point and row
13's form 0, at `RING_CASES` and M = 1 and 16, on
`int4_stream.stream_plan`), all of them unless named on the command line.
For each case, at this checkout's plan: the two libraries' outputs,
compared bit for bit, then `ROUNDS` rounds that time this library's launch
and the other's (L2 flushed before each launch), in the order this, other,
other, this, and the fastest time of each. One JSON line per case, then
one per form with this library's time over the other's, mean, least and
most. Calls the C entry points directly; no launch is counted.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, quant
from uniaudio2_tpu_torch.probes.gemv_splitk_sweep import CASES, ENTRY, FORMS, weight

ROWS = (1, 2, 16)
ROUNDS = 3
# the TMA ring's default form through row 11's and row 13's entry points
RING = {"ring-int4i": "ua2_gemv_int4_native", "ring-int4": "ua2_gemv_int4_sweep"}
# (label, K, N): row 11 at its probe's row shape, row 13 at the backbone's
# qkv and the audio head (a partial last tile)
RING_CASES = {"ring-int4i": (("native", 3072, 8192),),
              "ring-int4": (("bb_qkv", 3072, 5120), ("audio_head", 2048, 12300))}
RING_ROWS = (1, 16)

_OTHER = """
import json
from uniaudio2_tpu_torch.ops import _cuda
print(json.dumps({"lib": str(_cuda.build()),
                  "args": {k: len(v) for k, v in _cuda._SIGNATURES.items()}}))
"""


def other_library(root: str):
    """Build the kernel library of the checkout at ``root`` and load it:
    returns the library, its entry points' argument types set from this
    checkout's signatures (``_GEMV_ROWS``, less the scratch pointer where
    the other build's entry point has none), and the forms whose entry
    point there takes the plan."""
    out = subprocess.run([sys.executable, "-c", _OTHER], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    info = json.loads(out.strip().splitlines()[-1])
    lib = ctypes.CDLL(info["lib"])
    planned = set()
    for name in set(ENTRY.values()) | set(RING.values()):
        args = _cuda._SIGNATURES[name]
        if info["args"].get(name, 0) < len(args) - 1:
            continue                     # no plan arguments there
        planned.add(name)
        fn = getattr(lib, name)
        fn.argtypes = args if info["args"][name] == len(args) else \
            args[:-2] + args[-1:]
        fn.restype = ctypes.c_int
    return lib, tuple(f for f in FORMS + tuple(RING)
                      if {**ENTRY, **RING}[f] in planned)


def cases(form):
    """(label, K, N, residual, f32 out, rows) of ``form``'s cases."""
    if form in RING:
        return tuple((label, k, n, False, False, RING_ROWS)
                     for label, k, n in RING_CASES[form])
    return tuple(c + (ROWS,) for c in CASES)


def plan_of(form, w, m, k, n, sms):
    """This checkout's plan of a case: the ring's (splits, span), or
    `quant.gemv_plan`."""
    if form in RING:
        return int4_stream.stream_plan(m, k, n, sms)
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    return quant.gemv_plan(m, k, n, g, quant.LAYOUTS[type(w)], sms)


def launch(lib, form, w, x, plan, residual, out):
    """One launch of ``form``'s GEMV from ``lib`` with ``plan``."""
    m, k = x.shape
    n = w.scale.shape[-1]
    if form in RING:
        entry = RING[form]
        args = [_cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale),
                _cuda.ptr(out), m, k, n, w.values.shape[1]]
        if form == "ring-int4i":
            args.append(0)                     # row-major bytes
        else:
            args.insert(0, 0)                  # form 0
        _cuda.check(getattr(lib, entry)(*args, *plan, _cuda.stream_of(x)),
                    entry)
        return
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    fn = getattr(lib, ENTRY[form])
    args = [_cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale), None,
            _cuda.ptr(residual), _cuda.ptr(out), m, k, n, w.values.shape[1], g,
            1e-5, int(out.dtype == torch.float32), plan.splits, plan.mt,
            plan.span]
    if len(fn.argtypes) == len(args) + 2:
        args.append(None)                      # the tile kernel's scratch
    _cuda.check(fn(*args, _cuda.stream_of(x)), ENTRY[form])


def main(other_root: str, only=(), device: str = "cuda"):
    """Run the comparison (of the forms named in ``only``, or all); print
    one JSON line per case and a summary per form, and return the cases."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card

    dev = torch.device(device)
    other, forms = other_library(other_root)
    forms = tuple(f for f in forms if not only or f in only)
    libs = {"this": _cuda.lib(), "other": other}
    gen = torch.Generator(device=dev).manual_seed(9)
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "splitk_ab", "card": card(), "sms": sms,
                      "other": other_root, "forms": forms}), flush=True)
    lines = []
    for form in forms:
        for label, k, n, res, f32, rows in cases(form):
            w = weight(form.removeprefix("ring-"), k, n, gen, dev)
            for m in rows:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                r = (torch.randn((m, n), generator=gen, device=dev) * 0.1).to(
                    torch.bfloat16) if res else None
                dtype = torch.float32 if f32 else torch.bfloat16
                plan = plan_of(form, w, m, k, n, sms)
                outs = {who: torch.empty((m, n), dtype=dtype, device=dev)
                        for who in libs}
                for who, lib in libs.items():
                    launch(lib, form, w, x, plan, r, outs[who])
                torch.cuda.synchronize()
                us = {who: [] for who in libs}
                for _ in range(ROUNDS):
                    for who in ("this", "other", "other", "this"):
                        us[who].append(timer(lambda: launch(
                            libs[who], form, w, x, plan, r, outs[who])) * 1e3)
                best = {who: min(t) for who, t in us.items()}
                line = {"form": form, "shape": label, "K": k, "N": n, "M": m,
                        "splits": plan[0] if form in RING else plan.splits,
                        "same_bits": torch.equal(outs["this"], outs["other"]),
                        "us": best, "this_over_other": best["this"] / best["other"]}
                print(json.dumps(line), flush=True)
                lines.append(line)
    for form in forms:
        ratios = [line["this_over_other"] for line in lines
                  if line["form"] == form]
        print(json.dumps({"form": form, "cases": len(ratios),
                          "this_over_other_mean": sum(ratios) / len(ratios),
                          "least": min(ratios), "most": max(ratios),
                          "same_bits": all(line["same_bits"] for line in lines
                                           if line["form"] == form)}),
              flush=True)
    return lines


if __name__ == "__main__":
    main(sys.argv[1], tuple(sys.argv[2:]))
