"""Batch-1 int8 GEMV strategies on the H100 (port of
`scripts/profile_gemv.py`).

    python -m uniaudio2_tpu_torch.probes.profile_gemv

The TPU probe asked whether its int8 kernel was held back by the matrix
unit at M = 1 and timed a vector-unit multiply-and-reduce kernel
(`vpu_gemv`) against it. On the H100 the question is whether an M = 1 int8
GEMV fills the 132 SMs and reaches the 3.35 TB/s. Variants per shape (the
TPU names in brackets):

  int8_matmul (pallas512 / pallas2048)  the production kernel, gemv_int8.cu
  bf16_matmul (xla_bf16)                torch.matmul in bf16 (2x the bytes)
  int_mm      (xla_int8)                x quantized to int8 per call, then
                                        torch._int_mm (M padded to 32)
  splitk      (vpu)                     row 12's kernel, gemv_int8_splitk.cu:
                                        the TMA ring's int8 form, one launch
  splitk_twopass                        its first design (two passes, an f32
                                        workspace)

Each is timed as the JAX script times it: ``UA2_GEMV_ITERS`` (default 400)
dependent calls in a chain (the output, cut or tiled to K and scaled by
1e-3, is the next input), here between two CUDA events, and reported as GB/s
of weight bytes (K x N_pad; K x N x 2 for bf16) beside the byte bound at
3.35 TB/s. ``UA2_GEMV_ALL=1`` adds three shapes. Before timing, the
split-K kernels are held against their twin (one bf16 ulp, 2^-7 x
max|twin|), row 12's to the production kernel's bits (the same split-K
plan and order) and the production kernel against its own twin (2e-2 x
max|twin|). The two variables choose shapes and iterations only.
"""

from __future__ import annotations

import json
import os

import torch

from uniaudio2_tpu_torch.ops import int4_stream, quant, splitk_gemv
from uniaudio2_tpu_torch.probes import PEAK_BYTES

SHAPES = ((3072, 8192), (8192, 3072), (2048, 8192))
MORE_SHAPES = ((3072, 5120), (3072, 3072), (2048, 4096))


def shapes():
    return SHAPES + (MORE_SHAPES if os.environ.get("UA2_GEMV_ALL") == "1"
                     else ())


def chained_ms(step, x, n_iter):
    """Mean ms of one link of a chain of ``n_iter`` dependent calls."""
    k = x.shape[-1]

    def run(x):
        for _ in range(n_iter):
            y = step(x)
            if y.shape[-1] < k:
                y = y.repeat(1, -(-k // y.shape[-1]))
            x = (y[:, :k] * 1e-3).to(torch.bfloat16)
        return x

    run(x)                                  # warm-up (and any first build)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def int_mm_step(w):
    """x quantized per call to int8 (absmax), then an int8 x int8 -> int32
    product on the tensor cores, M padded to 32 as `_int_mm` needs."""
    n = w.scale.shape[-1]

    def step(x):
        xs = (x.float().abs().max() + 1e-6) / 127.0
        xq = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 31))
        acc = torch._int_mm(xq, w.values)[:1, :n]
        return (acc.float() * xs * w.scale).to(torch.bfloat16)

    return step


def check(x, w):
    """Row 12's kernel and its first design against their twin, row 12's
    against the production kernel's bits, and the production kernel
    against its own twin, on ``x``. Returns the three relative errors."""
    out = splitk_gemv.int8_splitk_gemv(x, w.values, w.scale)
    two = splitk_gemv.int8_splitk_gemv_twopass(x, w.values, w.scale)
    ref = splitk_gemv.int8_splitk_gemv_plain(x, w.values, w.scale)
    prod = quant.int8_matmul(x, w.values, w.scale)
    prod_ref = quant.int8_matmul_plain(x, w.values, w.scale)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    e1, e2, e3 = rel(out, ref), rel(prod, prod_ref), rel(two, ref)
    if e1 > 2.0 ** -7 or e3 > 2.0 ** -7 or e2 > 2e-2 or not torch.equal(out, prod):
        raise AssertionError(f"GEMV check failed: split-K {e1:.3e} (the "
                             f"production bits: {torch.equal(out, prod)}), "
                             f"two-pass {e3:.3e}, production {e2:.3e}")
    return e1, e2, e3


def main(device: str = "cuda", n_iter: int = 0):
    """Run the probe; print one JSON line per shape and return the lines."""
    from uniaudio2_tpu_torch.probes import card

    n_iter = n_iter or int(os.environ.get("UA2_GEMV_ITERS", "400"))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    print(json.dumps({"probe": "profile_gemv", "card": card(),
                      "iters": n_iter}), flush=True)
    lines = []
    for k, n in shapes():
        w = quant.quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        wb = quant.dequantize(w).to(torch.bfloat16)        # (k, n)
        npad = w.values.shape[-1]
        e_splitk, e_prod, e_two = check(
            torch.randn((1, k), generator=gen, device=dev).to(torch.bfloat16), w)
        x = torch.ones((1, k), dtype=torch.bfloat16, device=dev)
        steps = {
            "int8_matmul": (lambda x: quant.int8_matmul(x, w.values, w.scale),
                            k * npad),
            "bf16_matmul": (lambda x: torch.matmul(x, wb), k * n * 2),
            "int_mm": (int_mm_step(w), k * npad),
            "splitk": (lambda x: splitk_gemv.int8_splitk_gemv(x, w.values,
                                                              w.scale),
                       k * npad),
            "splitk_twopass": (lambda x: splitk_gemv.int8_splitk_gemv_twopass(
                x, w.values, w.scale), k * npad),
        }
        us, gbps, bound_us = {}, {}, {}
        for name, (step, n_bytes) in steps.items():
            ms = chained_ms(step, x, n_iter)
            us[name] = ms * 1e3
            gbps[name] = n_bytes / ms / 1e6
            bound_us[name] = n_bytes / PEAK_BYTES * 1e6
        line = {"shape": [k, n], "GBps": gbps, "us_per_call": us,
                "bound_us": bound_us,
                "splitk_plan": list(int4_stream.stream_plan(
                    1, k, n, quant._sm_count(dev), splitk_gemv.FORM,
                    quant.LAYOUT_INT8)),
                "twopass_plan": list(splitk_gemv.plan(k, n)),
                "splitk_vs_twin": e_splitk, "twopass_vs_twin": e_two,
                "int8_matmul_vs_twin": e_prod}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del w, wb
    return lines


if __name__ == "__main__":
    main()
