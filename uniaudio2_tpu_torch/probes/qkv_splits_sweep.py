"""The fused QKV step at decode (row 3, `csrc/qkv_rope.cu`: the split-K
kernel's QKV mode) at every legal number of K-slices, on the H100: whether
`quant.gemv_plan`'s `SPLITK_BLOCKS_PER_SM`, tuned on rows 1, 5 and 6's
GEMVs, also fits the QKV step (N = (H + 2G) hd = 5120 at the backbone,
3072 at the decoder, with the norm and the rotation), and the sweep behind
`qkv_step.QKV_MAX_SPLITS`, the QKV plan's cap on the slice count.

    python -m uniaudio2_tpu_torch.probes.qkv_splits_sweep

For each of the five modes, both widths and M = 1, 2, 8 and 16: the median
time of one call, L2 flushed before each, at every legal slice count
(`quant.splitk_slices`, up to `quant.SPLITK_MAX_SPLITS`), beside the
slice count the plan picks. One JSON
line per case, then one with the plan's time over the fastest slice
count's, mean and worst. Calls ``ua2_qkv_rope`` directly with each plan;
no launch is counted.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import _cuda, qkv_step, quant

FORMS = ("int4i", "int4ig", "int4", "int4g", "int8")
# (label, K, H, G, hd)
WIDTHS = (("backbone", 3072, 24, 8, 128), ("decoder", 2048, 32, 8, 64))
ROWS = (1, 2, 8, 16)


def weight(form, k, n, gen, dev):
    """A seeded (k, n) weight in the container of ``form``."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    if form == "int8":
        return quant.quantize(w)
    q = quant.quantize4_grouped(w) if form in ("int4g", "int4ig") else \
        quant.quantize4(w)
    return quant.to_interleaved(q) if form in ("int4i", "int4ig") else q


def launch(w, x, nw, cos, sin, h, g, hd, splits, span):
    """One launch of the QKV mode with the given plan."""
    b, k = x.shape
    groups = w.scale.shape[0] if w.scale.ndim == 2 else 0
    q = torch.empty((b, h * hd), dtype=x.dtype, device=x.device)
    k_out, v_out = (torch.empty((b, g * hd), dtype=x.dtype, device=x.device)
                    for _ in range(2))
    err = _cuda.lib().ua2_qkv_rope(
        _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale), _cuda.ptr(nw),
        _cuda.ptr(cos), _cuda.ptr(sin), _cuda.ptr(q), _cuda.ptr(k_out),
        _cuda.ptr(v_out), b, k, h, g, hd, quant.LAYOUTS[type(w)], groups,
        1e-5, splits, span, _cuda.stream_of(x))
    _cuda.check(err, "ua2_qkv_rope")
    return q, k_out, v_out


def main(device: str = "cuda"):
    """Run the sweep; print one JSON line per case and a summary, and
    return the cases."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(14)
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "qkv_splits_sweep", "card": card(), "sms": sms,
                      "blocks_per_sm": quant.SPLITK_BLOCKS_PER_SM}),
          flush=True)
    lines = []
    for form in FORMS:
        for label, k, h, g, hd in WIDTHS:
            n = (h + 2 * g) * hd
            w = weight(form, k, n, gen, dev)
            groups = w.scale.shape[0] if w.scale.ndim == 2 else 0
            layout = quant.LAYOUTS[type(w)]
            nw = torch.randn(k, generator=gen, device=dev).to(torch.bfloat16)
            cos, sin = (torch.rand(hd, generator=gen, device=dev)
                        for _ in range(2))
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                args = (w, x, nw, cos, sin, h, g, hd)
                ref = qkv_step.qkv_rope_step(x, w, nw, 1e-5, cos, sin, h, g, hd)
                us = {}
                for s, span in quant.splitk_slices(k, groups, layout):
                    got = launch(*args, s, span)
                    for a, b in zip(got, ref):      # another order of sums
                        err = (a.float() - b.float()).abs().max().item()
                        if not err <= 2e-2 * b.float().abs().max().item():
                            raise RuntimeError(f"{form} {label} M={m} S={s}: "
                                               f"{err} from the plan's output")
                    us[s] = timer(lambda: launch(*args, s, span)) * 1e3
                plan = quant.gemv_plan(m, k, n, groups, layout, sms,
                                       qkv_step.QKV_MAX_SPLITS)
                best = min(us, key=us.get)
                line = {"form": form, "width": label, "K": k, "N": n, "M": m,
                        "us_by_splits": us, "plan_splits": plan.splits,
                        "best_splits": best,
                        "plan_over_best": us[plan.splits] / us[best]}
                print(json.dumps(line), flush=True)
                lines.append(line)
    ratios = [line["plan_over_best"] for line in lines]
    print(json.dumps({"cases": len(lines),
                      "plan_over_best_mean": sum(ratios) / len(ratios),
                      "plan_over_best_worst": max(ratios)}), flush=True)
    return lines


if __name__ == "__main__":
    main()
