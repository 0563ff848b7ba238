"""Row 5's K-split int4 GEMV in twelve tile forms, on the H100 (port of
`scripts/sweep_gemv_blocks.py`).

    python -m uniaudio2_tpu_torch.probes.sweep_gemv_blocks

The TPU probe swept the tile width (bn 512 / 1024 / 2048) and the unpack
width (int32 or int16 shifts) of the K-split GEMV at four serving shapes,
at M = 1. On the H100 the parameters are the kernel template's own
(`ops/int4_sweep.py` FORMS): byte columns a lane loads, weight rows in
flight, the unpack (shifts and conversions, or the magic-number form of
row 11) and activation rows a block reuses (MT 4, 8, 16). The production
kernels keep MT = 4, so at M = 8 and 16 (a batched decode's rows) they read
every weight byte two and four times, the later reads through L2; the
sweep says what that costs.

At each shape (backbone qkv 3072 -> 5120, attn_proj 3072 -> 3072, decoder
qkv 2048 -> 4096, audio head 2048 -> 12300) and M = 1, 8, 16, on the bytes
of the port's ``quantize4``: every form held to the twin (one bf16 ulp)
and form 0 to the tiled instance of the production `gemv_int4.cu` bit for
bit (`quant.int4_matmul_tiled`: at M <= 16 `quant.int4_matmul` launches the
split-K kernel, which sums in another order); then the median time of one
launch, L2 flushed before each, of every form, the production wrapper
`quant.int4_matmul` and one ``torch._weight_int4pack_mm`` call (repacked
once), with
GB/s of weight bytes and the bound (weight bytes, scale, x and output at
3.35 TB/s; 2.4 / 1.4 / 1.3 / 3.8 us at M = 1). One JSON line per (shape,
M). The counter counts the timed launches only.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_sweep, quant

SHAPES = (("bb_qkv", 3072, 5120), ("bb_attnproj", 3072, 3072),
          ("dec_qkv", 2048, 4096), ("audio_head", 2048, 12300))
ROWS = (1, 8, 16)
ULP = 2.0 ** -7


def bound_us(k: int, n: int, m: int) -> float:
    """The least time of one call (us): K x N / 2 weight bytes, the f32
    scale, x and the bf16 output, at 3.35 TB/s (the 2 M K N operations
    bound nothing at these M)."""
    from uniaudio2_tpu_torch.probes import bound_us as least

    return least(k * n // 2 + 4 * n + 2 * m * (k + n), 2 * m * k * n)


def check(x, w):
    """Every form against the twin, form 0 against `gemv_int4.cu`'s tiled
    instance bit for bit. Returns the worst |kernel - twin| and that
    bit-identity."""
    ref = int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale)
    tol = ULP * ref.float().abs().max().item()
    worst = 0.0
    for i, form in enumerate(int4_sweep.FORMS):
        out = int4_sweep.int4_sweep_matmul(x, w.values, w.scale, i)
        err = (out.float() - ref.float()).abs().max().item()
        if err > tol:
            raise AssertionError(f"int4 sweep form {form.name} disagrees with "
                                 f"its twin: {err:.3e} > {tol:.3e}")
        worst = max(worst, err)
    prod = quant.int4_matmul_tiled(x, w.values, w.scale)
    same = torch.equal(int4_sweep.int4_sweep_matmul(
        x, w.values, w.scale, int4_sweep.PRODUCTION), prod)
    torch.cuda.synchronize()
    return worst, bool(same)


def main(device: str = "cuda"):
    """Run the sweep; print one JSON line per (shape, M) and return them."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card, int4_tinygemm

    int4_sweep.check_forms()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(13)
    timer = FlushedTimer(dev)
    print(json.dumps({"probe": "sweep_gemv_blocks", "card": card(),
                      "forms": [f.name for f in int4_sweep.FORMS]}),
          flush=True)
    cases = []
    for name, k, n in SHAPES:
        w = quant.quantize4(torch.randn((k, n), generator=gen, device=dev)
                            * 0.02)
        lib = int4_tinygemm(w)
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            cases.append((name, k, n, m, w, lib, x) + check(x, w))
    _cuda.reset_count(int4_sweep.int4_sweep_matmul)     # timed launches only
    lines = []
    for name, k, n, m, w, lib, x, err, same in cases:
        us = {f.name: timer(lambda i=i: int4_sweep.int4_sweep_matmul(
            x, w.values, w.scale, i)) * 1e3
            for i, f in enumerate(int4_sweep.FORMS)}
        prod_us = timer(lambda: quant.int4_matmul(x, w.values, w.scale)) * 1e3
        lib_us = timer(lambda: torch._weight_int4pack_mm(x, *lib)) * 1e3
        best = min(us, key=us.get)
        line = {"shape": name, "K": k, "N": n, "M": m, "us": us,
                "GBps": {f: k * n / 2 / t / 1e3 for f, t in us.items()},
                "best": best, "int4_matmul_us": prod_us,
                "weight_int4pack_mm_us": lib_us, "bound_us": bound_us(k, n, m),
                "forms_vs_twin": err, "form0_bit_identical_to_int4_tiled": same}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
