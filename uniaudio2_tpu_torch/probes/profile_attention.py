"""The two attention hot shapes on the H100 (port of
`scripts/profile_attention.py`).

    python -m uniaudio2_tpu_torch.probes.profile_attention

The TPU probe asked whether the production einsum attention needs a flash
kernel, at two shapes:

  1. the backbone's prefill: B 1, H 24 over G 8 K/V groups (GQA), hd 128,
     T 2048 (the largest prompt bucket), causal; the TPU kernel took K/V
     repeated to 24 heads (`bb_flash`);
  2. the DiT's self-attention: B 2 (CFG), H 24, hd 64, T 768 (a 30 s
     window), non-causal.

For each: the port's production path (`ops.attention.causal_attention`, f32
scores and softmax; the DiT's einsum form, `attention_plain`), the flash
kernel (`csrc/flash_attn.cu`: causal with the head map for case 1), and one
``scaled_dot_product_attention`` call (``is_causal``, ``enable_gqa``) as the
library's time, never used by the port. Each is run as many times as the
TPU probe's loop (28 x 8 and 32 x 8 layers) between two CUDA events; one
JSON line per path with the per-layer ms, beside the bound (operations at
989 TFLOP/s or bytes at 3.35 TB/s, the larger). Before timing, the kernel
is held against its twin and the production path, row by row: each query
row within 2e-2 x its own max (a causal row i averages i + 1 values, so
late rows are far smaller than row 0).
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import flash_attention as fa
from uniaudio2_tpu_torch.ops.attention import causal_attention
from uniaudio2_tpu_torch.probes import PEAK_BF16, PEAK_BYTES

RTOL = 2e-2
# (name, B, H, G, hd, T, causal, layers of the TPU probe's loop)
CASES = (("backbone_prefill_T2048", 1, 24, 8, 128, 2048, True, 28 * 8),
         ("dit_T768", 2, 24, 24, 64, 768, False, 32 * 8))


def bound_ms(b, h, g, hd, t, causal):
    """Least time of one call: the products (half of them when causal) at
    the bf16 peak, or q, k, v and o once at the HBM rate, the larger."""
    flops = 4 * b * h * t * t * hd // (2 if causal else 1)
    n_bytes = 2 * t * hd * b * (2 * h + 2 * g)
    return max(flops / PEAK_BF16, n_bytes / PEAK_BYTES) * 1e3


def timed_ms(fn, n):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def paths(q, k, v, causal):
    """name -> callable of one layer's attention, (B, H, T, hd) out."""
    b, h, t, hd = q.shape
    scale = hd ** -0.5
    if causal:
        def production():
            return causal_attention(q, k, v, scale=scale).reshape(
                b, t, h, hd).transpose(1, 2)
    else:
        def production():
            return fa.attention_plain(q, k, v, scale)
    return {
        "einsum": production,
        "flash": lambda: fa.flash_attention(q, k, v, scale, causal=causal),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=k.shape[1] != h),
    }


def main(device: str = "cuda"):
    """Run the probe; print one JSON line per (case, path), return them."""
    from uniaudio2_tpu_torch.probes import card

    dev = torch.device(device)
    print(json.dumps({"probe": "profile_attention", "card": card()}), flush=True)
    lines = []
    for seed, (name, b, h, g, hd, t, causal, layers) in enumerate(CASES):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, h, t, hd), (b, g, t, hd), (b, g, t, hd)))
        run = paths(q, k, v, causal)
        out = run["flash"]().float()
        twin = fa.attention_plain(q, k, v, hd ** -0.5, causal).float()
        prod = run["einsum"]().float()
        errs = {ref: ((out - r).abs().amax(-1) / r.abs().amax(-1)).max().item()
                for ref, r in (("twin", twin), ("einsum", prod))}
        if max(errs.values()) > RTOL:
            raise AssertionError(f"{name}: flash kernel off by {errs}")
        del out, twin, prod
        ms = {path: timed_ms(fn, layers) for path, fn in run.items()}
        for path, total in ms.items():
            line = {"case": name, "path": path, "ms_total": total,
                    "ms_per_layer": total / layers,
                    "bound_ms_per_layer": bound_ms(b, h, g, hd, t, causal),
                    "speedup_vs_einsum": ms["einsum"] / total}
            if path == "flash":
                line["worst_row_err_vs"] = errs
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
