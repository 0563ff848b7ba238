"""Row 1's int4 GEMV with a conversion-free nibble unpack, on the H100
(port of `scripts/int4_native_probe.py`).

    python -m uniaudio2_tpu_torch.probes.int4_native_probe

The TPU probe asked whether the int32 shift chain that unpacks row 1's
nibbles costs time the weight stream does not hide, and handed the
i4 -> bf16 conversion to the hardware. On the H100 the question is how
the bytes arrive: `int4_native_matmul` runs the TMA-ring split-K GEMV
(`csrc/gemv_int4_stream.cuh`: a producer warp keeps a ring of weight
boxes full by TMA, four warps consume it on the tensor cores) in the
split-K kernel's plan and sum order, so it gives the bits of
`quant.int4i_matmul` (the main path's decode GEMV, whose warps load their
bytes into registers) and answers whether a TMA ring reads the same
bytes faster. The first design (`int4_native_matmul_simt`: CUDA-core
FMAs, the tiled instance's order and bits) stays as the yardstick.

At the TPU probe's shapes (K, N) = (256, 512), (512, 1024) and (3072, 8192)
and M = 1, 8 and 16 (a batched decode's rows), on the bytes of the port's
``quantize4`` made row-interleaved (`to_interleaved`), row-major and
chunk-major (C, K/2, 512): the kernel held to its twin (one bf16 ulp), its
two byte orders to each other's bits and, at M <= 16, to
`quant.int4i_matmul`'s bits; the first design to the tiled instance's
bits; then the median time of one launch, L2 flushed before each, of the
kernel (both byte orders), the first design, the split-K wrapper
`quant.int4i_matmul` and one ``torch._weight_int4pack_mm`` call (repacked
once), beside the bound (the weight bytes, scale, x and output at 3.35
TB/s). The (256, 512) case moves almost no bytes: its time is the
design's fixed cost (launch, cluster, prologue, reduction), beside the
timer's own floor, one launch of a one-element fill (``floor_us`` in the
first line). One JSON line per (shape, M). The counters count the timed
launches only.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_native, int4_stream, quant

SHAPES = ((256, 512), (512, 1024), (3072, 8192))
ROWS = (1, 8, 16)
CHUNK = 512
ULP = 2.0 ** -7


def chunk_major(values: torch.Tensor, bn: int) -> torch.Tensor:
    """(K/2, N_pad) bytes -> (N_pad / bn, K/2, bn), as the JAX probe lays
    them out."""
    k2, n = values.shape
    return values.reshape(k2, n // bn, bn).permute(1, 0, 2).contiguous()


def check(x, w, chunked):
    """The kernel (row-major and chunk-major) against its twin and each
    other, and at M <= 16 against the split-K kernel bit for bit; the first
    design against the tiled instance bit for bit. Returns (max|kernel -
    twin|, split-K bits (None above 16 rows), the first design's bits)."""
    out = int4_native.int4_native_matmul(x, w.values, w.scale)
    out_c = int4_native.int4_native_matmul(x, chunked, w.scale)
    ref = int4_native.int4_native_matmul_plain(x, w.values, w.scale)
    simt = int4_native.int4_native_matmul_simt(x, w.values, w.scale)
    splitk = quant.int4i_matmul(x, w.values, w.scale) \
        if x.shape[0] <= quant.SPLITK_MAX_M else None
    tiled = quant.int4i_matmul_tiled(x, w.values, w.scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if err > ULP * ref.float().abs().max().item() or not torch.equal(out, out_c):
        raise AssertionError(f"int4 native GEMV disagrees with its twin: "
                             f"{err:.3e}, layouts equal {torch.equal(out, out_c)}")
    same = None if splitk is None else bool(torch.equal(out, splitk))
    return err, same, bool(torch.equal(simt, tiled))


def main(device: str = "cuda"):
    """Run the probe; print one JSON line per (shape, M) and return them."""
    from uniaudio2_tpu_torch.probes import (
        FlushedTimer, bound_us, card, int4_tinygemm,
    )

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    timer = FlushedTimer(dev)
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"probe": "int4_native_probe", "card": card(),
                      "floor_us": timer(lambda: tiny.zero_()) * 1e3}),
          flush=True)
    cases = []
    for k, n in SHAPES:
        w = quant.to_interleaved(quant.quantize4(
            torch.randn((k, n), generator=gen, device=dev) * 0.02))
        chunked = chunk_major(w.values, CHUNK)
        lib = int4_tinygemm(w) if k % 256 == 0 else None
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases.append((k, n, m, w, chunked, lib, x)
                         + check(x, w, chunked))
    _cuda.reset_count(int4_native.int4_native_matmul)   # timed launches only
    _cuda.reset_count(int4_native.int4_native_matmul_simt)
    lines = []
    for k, n, m, w, chunked, lib, x, err, same, simt_same in cases:
        us = {
            "stream": timer(lambda: int4_native.int4_native_matmul(
                x, w.values, w.scale)) * 1e3,
            "stream_chunk_major": timer(lambda: int4_native.int4_native_matmul(
                x, chunked, w.scale)) * 1e3,
            "simt": timer(lambda: int4_native.int4_native_matmul_simt(
                x, w.values, w.scale)) * 1e3,
            "int4i_matmul": timer(lambda: quant.int4i_matmul(
                x, w.values, w.scale)) * 1e3,
        }
        if lib is not None:
            us["weight_int4pack_mm"] = timer(
                lambda: torch._weight_int4pack_mm(x, *lib)) * 1e3
        n_bytes = k * n // 2 + 4 * n + 2 * m * (k + n)
        bound = bound_us(n_bytes, 2 * m * k * n)
        line = {"shape": [k, n], "M": m, "us": us,
                "GBps": {name: k * n / 2 / t / 1e3 for name, t in us.items()},
                "bound_us": bound, "bound_share": bound / us["stream"],
                "plan": int4_stream.stream_plan(m, k, n, quant._sm_count(dev)),
                "stream_vs_twin": err, "bit_identical_to_int4i_splitk": same,
                "simt_bit_identical_to_int4i_tiled": simt_same}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
