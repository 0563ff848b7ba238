"""Row 1's int4 GEMV with a conversion-free nibble unpack, on the H100
(port of `scripts/int4_native_probe.py`).

    python -m uniaudio2_tpu_torch.probes.int4_native_probe

The TPU probe asked whether the int32 shift chain that unpacks row 1's
nibbles costs time the weight stream does not hide, and handed the
i4 -> bf16 conversion to the hardware. On the H100 the tiled instance of
`gemv_int4i.cu` spends two shifts and two int -> float conversions (a
quarter-rate unit) on every byte; `gemv_int4_native.cu` turns each byte
into two exact bf16 numbers with an XOR, a multiply-add, a LOP3 and one
bf16x2 subtraction, and sums in the order of the production file's tiled
instance (`quant.int4i_matmul_tiled`: the prefill's kernel; at decode
`int4i_matmul` launches the split-K kernel, which sums in another order).

At the TPU probe's shapes (K, N) = (256, 512), (512, 1024) and (3072, 8192)
and M = 1, 8 and 16 (a batched decode's rows), on the bytes of the port's
``quantize4`` made row-interleaved (`to_interleaved`), row-major and
chunk-major (C, K/2, 512): the native kernel held to its twin (one bf16
ulp) and to the tiled instance (the same bits, which the line reports);
then the median time of one launch, L2 flushed before each, of the native
kernel (both layouts), the tiled instance, the production wrapper (the
split-K kernel at these M) and one
``torch._weight_int4pack_mm`` call (repacked once), beside the bound (the
weight bytes, scale, x and output at 3.35 TB/s). One JSON line per (shape,
M). The counter of the native kernel counts the timed launches only.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_native, quant

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
    """Native kernel (row-major and chunk-major) against its twin, and
    against the tiled instance bit for bit. Returns (max|kernel - twin|,
    bit-identical)."""
    out = int4_native.int4_native_matmul(x, w.values, w.scale)
    out_c = int4_native.int4_native_matmul(x, chunked, w.scale)
    ref = int4_native.int4_native_matmul_plain(x, w.values, w.scale)
    prod = quant.int4i_matmul_tiled(x, w.values, w.scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if err > ULP * ref.float().abs().max().item() or not torch.equal(out, out_c):
        raise AssertionError(f"int4 native GEMV disagrees with its twin: "
                             f"{err:.3e}, layouts equal {torch.equal(out, out_c)}")
    return err, bool(torch.equal(out, prod))


def main(device: str = "cuda"):
    """Run the probe; print one JSON line per (shape, M) and return them."""
    from uniaudio2_tpu_torch.probes import (
        FlushedTimer, bound_us, card, int4_tinygemm,
    )

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    timer = FlushedTimer(dev)
    print(json.dumps({"probe": "int4_native_probe", "card": card()}),
          flush=True)
    cases = []
    for k, n in SHAPES:
        w = quant.to_interleaved(quant.quantize4(
            torch.randn((k, n), generator=gen, device=dev) * 0.02))
        chunked = chunk_major(w.values, CHUNK)
        lib = int4_tinygemm(w) if k % 256 == 0 else None
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            err, same = check(x, w, chunked)
            cases.append((k, n, m, w, chunked, lib, x, err, same))
    _cuda.reset_count(int4_native.int4_native_matmul)   # timed launches only
    lines = []
    for k, n, m, w, chunked, lib, x, err, same in cases:
        us = {
            "native": timer(lambda: int4_native.int4_native_matmul(
                x, w.values, w.scale)) * 1e3,
            "native_chunk_major": timer(lambda: int4_native.int4_native_matmul(
                x, chunked, w.scale)) * 1e3,
            "int4i_matmul_tiled": timer(lambda: quant.int4i_matmul_tiled(
                x, w.values, w.scale)) * 1e3,
            "int4i_matmul": timer(lambda: quant.int4i_matmul(
                x, w.values, w.scale)) * 1e3,
        }
        if lib is not None:
            us["weight_int4pack_mm"] = timer(
                lambda: torch._weight_int4pack_mm(x, *lib)) * 1e3
        n_bytes = k * n // 2 + 4 * n + 2 * m * (k + n)
        line = {"shape": [k, n], "M": m, "us": us,
                "GBps": {name: k * n / 2 / t / 1e3 for name, t in us.items()},
                "bound_us": bound_us(n_bytes, 2 * m * k * n),
                "native_vs_twin": err, "bit_identical_to_int4i_tiled": same}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
