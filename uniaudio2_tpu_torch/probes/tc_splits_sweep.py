"""The tensor-core tile kernel (`csrc/gemv_int4_tc.cuh`) of rows 7 and 8
(column-packed) and 1 and 6 (row-interleaved, K-split) at every number of
K-slices from 1 to 8, on the H100: the sweep behind `quant.tc_plan`'s slice
count.

    python -m uniaudio2_tpu_torch.probes.tc_splits_sweep

For each form (column-packed int4 per channel and grouped; row-interleaved
per channel and grouped; K-split grouped; groups of 128 rows), each GEMV
that runs the tile kernel on the serving path (`CASES`: the MLP
down-projections of the column-packed forms; the QKV projection, attn_proj,
gate / up and the interleaved down-projection of the row-packed ones) and
each M of `ROWS`: the median time of one launch, L2 flushed before each, at
every slice count S whose slices are whole units and none empty, beside
the slice count the plan picks; first, for each S, the blocks a wave
holds by the plan's rule (`quant.tc_wave`) and the clusters of S blocks
the card holds at once (``cudaOccupancyMaxActiveClusters``). One JSON line per case, then one with the
plan's time over the fastest slice count's, mean and worst. The C entry
points are called directly with each plan (the K-split form's row kernel,
which reorders x, included); no launch is counted.
"""

from __future__ import annotations

import ctypes
import json
import math

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant

# (label, K, N) of the GEMVs that run the tile kernel alone, by form
C4_CASES = (("mlp_proj", 8192, 3072), ("decoder mlp_proj", 8192, 2048))
ROW_CASES = (("qkv", 3072, 5120), ("attn_proj", 3072, 3072),
             ("gate/up", 3072, 8192))
CASES = {"int4c": C4_CASES, "int4cg": C4_CASES,
         "int4i": ROW_CASES + (("mlp_proj", 8192, 3072),),
         "int4ig": ROW_CASES + (("mlp_proj", 8192, 3072),),
         "int4g": ROW_CASES}
ROWS = {"int4c": (255, 510), "int4cg": (255, 510), "int4i": (63, 255, 510),
        "int4ig": (63, 255, 510), "int4g": (63, 255, 510)}
FORMS = tuple(CASES)
ENTRY = {"int4c": "ua2_gemv_int4c", "int4cg": "ua2_gemv_int4cg",
         "int4i": "ua2_gemv_int4i", "int4ig": "ua2_gemv_int4i",
         "int4g": "ua2_gemv_int4g"}
LAYOUT = {"int4c": quant.LAYOUT_C4, "int4cg": quant.LAYOUT_C4,
          "int4i": quant.LAYOUT_I4, "int4ig": quant.LAYOUT_I4,
          "int4g": quant.LAYOUT_K4}


def slices(k, g, layout=quant.LAYOUT_C4):
    """{S: span} for every slice count of whole units (`quant.tc_plan`'s)
    with none empty."""
    lay = quant.tc_layout()
    group = (2 * k // g if layout == quant.LAYOUT_K4 else k // g) if g else 0
    unit = math.lcm(lay.bk, group) if g else lay.bk
    units = -(-k // unit)
    out = {}
    for s in range(1, lay.max_splits + 1):
        span = -(-units // s) * unit
        if -(-k // span) == s:
            out[s] = span
    return out


def weight(form, k, n, gen, dev):
    """A seeded (k, n) weight in the container of ``form``."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    q = {"int4c": quant.quantize4_cols, "int4cg": quant.quantize4_cols_grouped,
         "int4i": quant.quantize4, "int4ig": quant.quantize4_grouped,
         "int4g": quant.quantize4_grouped}[form](w)
    return quant.to_interleaved(q) if form in ("int4i", "int4ig") else q


def launch(form, w, x, splits, span, xn=None):
    """One launch of the tile kernel of ``form`` with the given plan (``xn``:
    the K-split form's scratch for the reordered x)."""
    m, k = x.shape
    n = w.scale.shape[-1]
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    name = ENTRY[form]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    plan = ((splits, span) if LAYOUT[form] == quant.LAYOUT_C4 else
            (splits, quant.tc_layout().bn, span, _cuda.ptr(xn)))
    err = getattr(_cuda.lib(), name)(
        _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale), None, None,
        _cuda.ptr(out), m, k, n, w.values.shape[1], g, 1e-5, 0, *plan,
        _cuda.stream_of(x))
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
    clusters = {}
    for s in range(1, quant.tc_layout().max_splits + 1):
        n = ctypes.c_int(0)
        _cuda.check(_cuda.lib().ua2_tc_max_clusters(s, ctypes.byref(n)),
                    "ua2_tc_max_clusters")
        clusters[s] = n.value
    print(json.dumps({"probe": "tc_splits_sweep", "card": card(), "sms": sms,
                      "wave_blocks_by_splits": {s: quant.tc_wave(s, sms)
                                                for s in clusters},
                      "max_active_clusters_by_splits": clusters}), flush=True)
    lines = []
    for form in forms:
        layout = LAYOUT[form]
        for label, k, n in CASES[form]:
            w = weight(form, k, n, gen, dev)
            g = w.scale.shape[0] if w.scale.ndim == 2 else 0
            for m in ROWS[form]:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                xn = torch.empty_like(x)
                us = {s: timer(lambda: launch(form, w, x, s, span, xn)) * 1e3
                      for s, span in slices(k, g, layout).items()}
                plan = quant.tc_plan(m, k, n, g, sms, layout)
                best = min(us, key=us.get)
                line = {"form": form, "shape": label, "K": k, "N": n, "M": m,
                        "us_by_splits": us, "plan_splits": plan.splits,
                        "plan_blocks": plan.blocks(m, n, layout),
                        "best_splits": best,
                        "best_blocks": quant.TcPlan(best, 0).blocks(m, n, layout),
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
