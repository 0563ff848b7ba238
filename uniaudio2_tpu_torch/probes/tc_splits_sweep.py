"""Rows 7 and 8's tensor-core tile kernel (`csrc/gemv_int4_tc.cuh`) at every
number of K-slices from 1 to 8, on the H100: the sweep behind
`quant.tc_plan`'s slice count.

    python -m uniaudio2_tpu_torch.probes.tc_splits_sweep

For each form (column-packed int4 per channel and grouped, groups of 128
rows), each MLP down-projection of the serving path (`CASES`) and M = 255
and 510 (a bucket-256 prefill and its CFG pair): the median time of one
launch, L2 flushed before each, at every slice count S whose slices are
whole units and none empty, beside the slice count the plan picks. One
JSON line per case, then one with the plan's time over the fastest slice
count's, mean and worst. The C entry points are called directly with each
plan; no launch is counted.
"""

from __future__ import annotations

import json
import math

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant

# (label, K, N) of the MLP down-projections that run the tile kernel alone
CASES = (("mlp_proj", 8192, 3072), ("decoder mlp_proj", 8192, 2048))
ROWS = (255, 510)
FORMS = ("int4c", "int4cg")
ENTRY = {"int4c": "ua2_gemv_int4c", "int4cg": "ua2_gemv_int4cg"}


def slices(k, g):
    """{S: span} for every slice count of whole units with none empty."""
    lay = quant.tc_layout()
    unit = math.lcm(lay.bk, k // g) if g else lay.bk
    units = -(-k // unit)
    out = {}
    for s in range(1, lay.max_splits + 1):
        span = -(-units // s) * unit
        if -(-k // span) == s:
            out[s] = span
    return out


def launch(form, w, x, splits, span):
    """One launch of the tile kernel of ``form`` with the given plan."""
    m, k = x.shape
    n = w.scale.shape[-1]
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    name = ENTRY[form]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = getattr(_cuda.lib(), name)(
        _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale), None, None,
        _cuda.ptr(out), m, k, n, w.values.shape[1], g, 1e-5, 0, splits, span,
        _cuda.stream_of(x))
    _cuda.check(err, name)
    return out


def main(device: str = "cuda"):
    """Run the sweep; print one JSON line per case and a summary, and
    return the cases."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(9)
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "tc_splits_sweep", "card": card(), "sms": sms}),
          flush=True)
    lines = []
    for form in FORMS:
        for label, k, n in CASES:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            w = (quant.quantize4_cols_grouped(w) if form == "int4cg"
                 else quant.quantize4_cols(w))
            g = w.scale.shape[0] if w.scale.ndim == 2 else 0
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                us = {s: timer(lambda: launch(form, w, x, s, span)) * 1e3
                      for s, span in slices(k, g).items()}
                plan = quant.tc_plan(m, k, n, g, sms)
                best = min(us, key=us.get)
                line = {"form": form, "shape": label, "K": k, "N": n, "M": m,
                        "us_by_splits": us, "plan_splits": plan.splits,
                        "plan_blocks": plan.blocks(m, n), "best_splits": best,
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
