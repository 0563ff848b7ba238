"""Rows 1, 4, 5 and 6's split-K GEMV (`csrc/gemv_int4_splitk.cuh`) at every
legal number of K-slices, on the H100: the sweep behind
`quant.gemv_plan`'s `SPLITK_BLOCKS_PER_SM` and its wide-N rule.

    python -m uniaudio2_tpu_torch.probes.gemv_splitk_sweep [FORM ...]

For each form (row-interleaved int4 per channel and grouped, K-split int4
per channel and grouped, groups of 128 rows, and int8; all of them, or
those named), each decode shape of the serving path (`CASES`; int8 also
the text lm_head, 3072 -> 128256) and M = 1, 2, 8 and 16 (a row, the CFG
pair, batched rows): the median time of one launch, L2 flushed before
each, at every legal slice count (`quant.splitk_slices`) and, for int8,
of the wide-N instance (one slice, 256 columns a block: "wide"), beside
what the plan picks. One JSON line per case, then one with the plan's
time over the fastest's, mean and worst. The C entry points are called
directly with each plan; no launch is counted.
"""

from __future__ import annotations

import json
import sys

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant

# (label, K, N, residual, f32 out) of the decode GEMVs of rows 1, 5 and 6
CASES = (("attn_proj", 3072, 3072, True, False),
         ("decoder attn_proj", 2048, 2048, True, False),
         ("audio_head", 2048, 12300, False, True),
         ("projection", 3072, 2048, False, False))
# int8 (row 4) also serves the text lm_head at decode
LM_HEAD = ("lm_head", 3072, 128256, False, True)
ROWS = (1, 2, 8, 16)
FORMS = ("int4i", "int4ig", "int4", "int4g", "int8")
ENTRY = {"int4i": "ua2_gemv_int4i", "int4ig": "ua2_gemv_int4i",
         "int4": "ua2_gemv_int4", "int4g": "ua2_gemv_int4g",
         "int8": "ua2_gemv_int8"}
WIDE_ENTRY = "ua2_gemv_int8_wide"


def cases(form):
    """The decode shapes ``form`` serves."""
    return CASES + ((LM_HEAD,) if form == "int8" else ())


def weight(form, k, n, gen, dev):
    """A seeded (k, n) weight in the container of ``form``."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    if form == "int8":
        return quant.quantize(w)
    if form == "int4g":
        return quant.quantize4_grouped(w)
    if form == "int4":
        return quant.quantize4(w)
    return quant.to_interleaved(quant.quantize4_grouped(w) if form == "int4ig"
                                else quant.quantize4(w))


def launch(form, w, x, splits, span, residual=None, out_dtype=None,
           name=None):
    """One launch of the split-K kernel of ``form`` with the given plan
    (through the entry point ``name``, else ``form``'s)."""
    m, k = x.shape
    n = w.scale.shape[-1]
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    name = name or ENTRY[form]
    out = torch.empty((m, n), dtype=out_dtype or torch.bfloat16,
                      device=x.device)
    err = getattr(_cuda.lib(), name)(
        _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale), None,
        _cuda.ptr(residual), _cuda.ptr(out), m, k, n, w.values.shape[1], g,
        1e-5, int(out.dtype == torch.float32), splits, quant.SPLITK_MAX_M,
        span, None, _cuda.stream_of(x))
    _cuda.check(err, name)
    return out


def main(device: str = "cuda", forms=FORMS):
    """Run the sweep over ``forms``; print one JSON line per case and a
    summary, and return the cases."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(9)
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "gemv_splitk_sweep", "card": card(),
                      "sms": sms,
                      "blocks_per_sm": quant.SPLITK_BLOCKS_PER_SM}),
          flush=True)
    lines = []
    for form in forms:
        for label, k, n, res, f32 in cases(form):
            w = weight(form, k, n, gen, dev)
            g = w.scale.shape[0] if w.scale.ndim == 2 else 0
            layout = quant.LAYOUTS[type(w)]
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                kw = dict(residual=(torch.randn((m, n), generator=gen,
                                                device=dev) * 0.1).to(
                              torch.bfloat16) if res else None,
                          out_dtype=torch.float32 if f32 else None)
                us = {s: timer(lambda: launch(form, w, x, s, span, **kw)) * 1e3
                      for s, span in quant.splitk_slices(k, g, layout)}
                plan = quant.gemv_plan(m, k, n, g, layout, sms,
                                       wide=form == "int8")
                chosen = plan.splits
                if form == "int8":
                    us["wide"] = timer(lambda: launch(
                        form, w, x, 1, k // 2, name=WIDE_ENTRY, **kw)) * 1e3
                    if plan.tile != quant.GEMV_TILE_N:
                        chosen = "wide"
                best = min(us, key=us.get)
                line = {"form": form, "shape": label, "K": k, "N": n, "M": m,
                        "us_by_splits": us, "plan_splits": chosen,
                        "best_splits": best,
                        "plan_over_best": us[chosen] / us[best]}
                print(json.dumps(line), flush=True)
                lines.append(line)
    ratios = [line["plan_over_best"] for line in lines]
    print(json.dumps({"cases": len(lines),
                      "plan_over_best_mean": sum(ratios) / len(ratios),
                      "plan_over_best_worst": max(ratios)}), flush=True)
    return lines


if __name__ == "__main__":
    main(forms=tuple(sys.argv[1:]) or FORMS)
