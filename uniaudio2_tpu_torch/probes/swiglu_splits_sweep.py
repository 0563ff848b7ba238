"""The fused SwiGLU's two split-K passes (row 2 at decode,
`csrc/fused_swiglu.cu`) at every legal number of K-slices of each pass, on
the H100: whether `quant.gemv_plan`'s `SPLITK_BLOCKS_PER_SM`, tuned on rows
1, 5 and 6's GEMVs, also fits these passes (pass 1: K = 3072 or 2048 over
the 2 I = 16384 columns of W1 and W2; pass 2: K = I = 8192 over W3).

    python -m uniaudio2_tpu_torch.probes.swiglu_splits_sweep

For each served form (`FORMS`), both widths and M = 1 and 16: the median
time of one call (both passes, the norm and the residual folded), L2
flushed before each, at every legal slice count of pass 1 with pass 2 at
its plan, and at every legal slice count of pass 2 with pass 1 at its plan
(`quant.splitk_slices`; a count whose staged slice does not fit the
block's 227 KB is refused by the kernel and recorded as null). One JSON
line per case and pass, then one with the plan's time over the fastest
slice count's, mean and worst, by pass. Calls `fused_mlp._passes` directly
with each plan; no launch is counted.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.ops import fused_mlp, quant

# gate / up and down forms of the serving trees, and (label, K, I)
FORMS = (("int4i", "int4i"), ("int4ig", "int4ig"), ("int4", "int4c"),
         ("int4g", "int4cg"), ("int8", "int8"))
WIDTHS = (("backbone", 3072, 8192), ("decoder", 2048, 8192))
ROWS = (1, 16)


def weight(form, k, n, gen, dev):
    """A seeded (k, n) weight in the container of ``form``."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    if form == "int8":
        return quant.quantize(w)
    q = {"int4": quant.quantize4, "int4i": quant.quantize4,
         "int4c": quant.quantize4_cols, "int4g": quant.quantize4_grouped,
         "int4ig": quant.quantize4_grouped,
         "int4cg": quant.quantize4_cols_grouped}[form](w)
    return quant.to_interleaved(q) if form in ("int4i", "int4ig") else q


def main(device: str = "cuda"):
    """Run the sweep; print one JSON line per case and pass and a summary,
    and return the lines."""
    from uniaudio2_tpu_torch.probes import FlushedTimer, card

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(13)
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"probe": "swiglu_splits_sweep", "card": card(),
                      "sms": sms,
                      "blocks_per_sm": quant.SPLITK_BLOCKS_PER_SM}),
          flush=True)
    lines = []
    for up, down in FORMS:
        for label, k, i in WIDTHS:
            w1, w2 = (weight(up, k, i, gen, dev) for _ in range(2))
            w3 = weight(down, i, k, gen, dev)
            g12, g3 = (w.scale.shape[0] if w.scale.ndim == 2 else 0
                       for w in (w1, w3))
            l12, l3 = quant.LAYOUTS[type(w1)], quant.LAYOUTS[type(w3)]
            nw = torch.randn(k, generator=gen, device=dev).to(torch.bfloat16)
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                res = (torch.randn((m, k), generator=gen, device=dev)
                       * 0.1).to(torch.bfloat16)
                plan = fused_mlp.swiglu_plan(m, k, i, k, g12, l12, g3, l3, sms)
                for which, kk, gg, ll, mine in (
                        ("pass 1", k, g12, l12, plan.up),
                        ("pass 2", i, g3, l3, plan.down)):
                    us = {}
                    for s, span in quant.splitk_slices(kk, gg, ll):
                        p = quant.GemvPlan(s, mine.mt, mine.tile, span)
                        trial = plan._replace(**{"up" if which == "pass 1"
                                                 else "down": p})
                        try:
                            us[s] = timer(lambda: fused_mlp._passes(
                                x, w1, w2, w3, nw, 1e-5, res, trial)) * 1e3
                        except RuntimeError:      # over the shared memory
                            us[s] = None
                    timed = {s: t for s, t in us.items() if t is not None}
                    best = min(timed, key=timed.get)
                    line = {"form": f"{up}+{down}", "width": label, "M": m,
                            "pass": which, "us_by_splits": us,
                            "plan_splits": mine.splits, "best_splits": best,
                            "plan_over_best": us[mine.splits] / us[best]}
                    print(json.dumps(line), flush=True)
                    lines.append(line)
    for which in ("pass 1", "pass 2"):
        ratios = [line["plan_over_best"] for line in lines
                  if line["pass"] == which]
        print(json.dumps({"pass": which, "cases": len(ratios),
                          "plan_over_best_mean": sum(ratios) / len(ratios),
                          "plan_over_best_worst": max(ratios)}), flush=True)
    return lines


if __name__ == "__main__":
    main()
