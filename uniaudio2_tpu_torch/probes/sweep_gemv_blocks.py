"""Row 5's K-split int4 GEMV in twelve forms, on the H100 (port of
`scripts/sweep_gemv_blocks.py`).

    python -m uniaudio2_tpu_torch.probes.sweep_gemv_blocks

The TPU probe swept the tile width (bn 512 / 1024 / 2048) and the unpack
width (int32 or int16 shifts) of the K-split GEMV at four serving shapes,
at M = 1. On the H100 the forms are points of the TMA-ring split-K GEMV's
own parameters (`ops/int4_sweep.py` FORMS, `csrc/gemv_int4_stream.cuh`):
the tile width (64 or 128 columns), the box (32, 64 or 128 byte rows),
the ring's stages (2-8), the slice rule (the host's plan, one slice, or
twice the plan's) and the unpack. The questions on the card: how many
bytes in flight a block the ring needs to stream at the card's rate, how
far the K split pays, and whether the unpack's cost (the conversion-free
form against two shifts and two int -> float conversions a byte, the TPU
probe's question of unpack width) shows once the bytes come by TMA. Form 0
sums in the split-K kernel's order (`quant.int4_matmul`, the main path's
decode GEMV of the K-split layout, its bytes loaded into registers): the
two are timed side by side on the same bits.

At each shape (backbone qkv 3072 -> 5120, attn_proj 3072 -> 3072, decoder
qkv 2048 -> 4096, audio head 2048 -> 12300) and M = 1, 8, 16, on the bytes
of the port's ``quantize4``: every form held to the twin (one bf16 ulp),
form 0 to `quant.int4_matmul` bit for bit; the first design's kept forms
(`SIMT_FORMS`, CUDA-core FMAs) to the twin and their form 0 to the tiled
instance of `gemv_int4.cu` bit for bit; then the median time of one
launch, L2 flushed before each, of every form, every first-design form,
the split-K wrapper `quant.int4_matmul` and one
``torch._weight_int4pack_mm`` call (repacked once), with GB/s of weight
bytes and the bound (weight bytes, scale, x and output at 3.35 TB/s; 2.4
/ 1.4 / 1.3 / 3.8 us at M = 1). One JSON line per (shape, M). The
counters count the timed launches only.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, int4_sweep, quant

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
    """Every form and first-design form against the twin; form 0 against
    the split-K kernel and the first design's form 0 against the tiled
    instance, bit for bit. Returns the worst |kernel - twin| and the two
    bit-identities."""
    ref = int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale)
    tol = ULP * ref.float().abs().max().item()
    worst = 0.0
    runs = [(f.name, lambda i=i: int4_sweep.int4_sweep_matmul(
        x, w.values, w.scale, i)) for i, f in enumerate(int4_sweep.FORMS)]
    runs += [(f"simt {f.name}", lambda i=i: int4_sweep.int4_sweep_matmul_simt(
        x, w.values, w.scale, i)) for i, f in enumerate(int4_sweep.SIMT_FORMS)]
    for name, run in runs:
        err = (run().float() - ref.float()).abs().max().item()
        if err > tol:
            raise AssertionError(f"int4 sweep form {name} disagrees with its "
                                 f"twin: {err:.3e} > {tol:.3e}")
        worst = max(worst, err)
    form0 = int4_sweep.int4_sweep_matmul(x, w.values, w.scale,
                                         int4_sweep.PRODUCTION)
    same = bool(torch.equal(form0, quant.int4_matmul(x, w.values, w.scale))) \
        if x.shape[0] <= quant.SPLITK_MAX_M else None
    simt_same = torch.equal(int4_sweep.int4_sweep_matmul_simt(
        x, w.values, w.scale), quant.int4_matmul_tiled(x, w.values, w.scale))
    torch.cuda.synchronize()
    return worst, same, bool(simt_same)


def main(device: str = "cuda"):
    """Run the sweep; print one JSON line per (shape, M) and return them."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card, int4_tinygemm

    int4_sweep.check_forms()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(13)
    timer = FlushedTimer(dev)
    sms = quant._sm_count(dev)
    print(json.dumps({"probe": "sweep_gemv_blocks", "card": card(),
                      "forms": [f.name for f in int4_sweep.FORMS],
                      "simt_forms": [f.name for f in int4_sweep.SIMT_FORMS]}),
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
    _cuda.reset_count(int4_sweep.int4_sweep_matmul_simt)
    lines = []
    for name, k, n, m, w, lib, x, err, same, simt_same in cases:
        us = {f.name: timer(lambda i=i: int4_sweep.int4_sweep_matmul(
            x, w.values, w.scale, i)) * 1e3
            for i, f in enumerate(int4_sweep.FORMS)}
        simt_us = {f.name: timer(lambda i=i: int4_sweep.int4_sweep_matmul_simt(
            x, w.values, w.scale, i)) * 1e3
            for i, f in enumerate(int4_sweep.SIMT_FORMS)}
        prod_us = timer(lambda: quant.int4_matmul(x, w.values, w.scale)) * 1e3
        lib_us = timer(lambda: torch._weight_int4pack_mm(x, *lib)) * 1e3
        best = min(us, key=us.get)
        line = {"shape": name, "K": k, "N": n, "M": m, "us": us,
                "GBps": {f: k * n / 2 / t / 1e3 for f, t in us.items()},
                "best": best, "simt_us": simt_us,
                "plans": {f.name: int4_stream.stream_plan(m, k, n, sms, f)
                          for f in int4_sweep.FORMS},
                "int4_matmul_us": prod_us,
                "weight_int4pack_mm_us": lib_us, "bound_us": bound_us(k, n, m),
                "forms_vs_twin": err, "form0_bit_identical_to_int4_splitk": same,
                "simt_form0_bit_identical_to_int4_tiled": simt_same}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
