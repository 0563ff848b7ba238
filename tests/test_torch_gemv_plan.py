"""The split-K int4 GEMV of rows 1, 5 and 6 (`csrc/gemv_int4_splitk.cuh`): its
host plan (`quant.gemv_plan`) and, on the CPU, a plain emulation of the
plan's fixed-order split sum, in the four row-packed forms (interleaved
per channel and grouped, K-split per channel and grouped).

The plan is a function of the shape and the SM count only. It must be
legal for every weight `check_weight` admits: 1-8 K-slices that cover the
K/2 byte rows with none empty, each holding whole scale groups (K/G / 2
byte rows interleaved, K/G K-split, in both nibble halves), all of up to
16 activation rows in one block. At the model's decode shapes it fills
the card (a block an SM or more).

The emulation adds, slice by slice in rank order, the f32 products of the
slice's activations (RMS-normalised and rounded to bf16) with the levels
(per channel: unscaled, the scale on the f32 sum; grouped: level x scale
rounded to bf16) and then the residual. It is held
 * to JAX's `_pallas_int4i_matmul` / `_pallas_int4_matmul` /
   `_pallas_int4g_matmul` in interpret
   mode with f32 output: the same arithmetic in another order of f32 sums,
   within 1e-5 x max|ref|;
 * to the port's plain twins (`int4i_matmul_plain` / `int4_matmul_plain` /
   `int4g_matmul_plain`,
   the XLA fallback's rounding, bf16 output): within 2e-2 x max|twin| per
   channel (the twin rounds scale x level to bf16 and the product before
   the residual), one bf16 ulp, 2^-7 x max|twin|, grouped without a
   residual (the same roundings, another order of the sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch.ops import quant
from uniaudio2_tpu_torch.ops.norms import rms_norm
from uniaudio2_tpu_torch.probes import gemv_splitk_sweep

SMS = 132                                  # an H100 SXM
I4, K4 = quant.LAYOUT_I4, quant.LAYOUT_K4
# (K, N) of the model's decode GEMVs of rows 1, 5 and 6
DECODE = ((3072, 3072), (2048, 2048), (2048, 12300), (3072, 2048))
FORMS = {"int4i": (I4, False), "int4ig": (I4, True), "int4": (K4, False),
         "int4g": (K4, True)}
JAX_FNS = {"int4i": jq._pallas_int4i_matmul, "int4ig": jq._pallas_int4i_matmul,
           "int4": jq._pallas_int4_matmul, "int4g": jq._pallas_int4g_matmul}
TWINS = {"int4i": quant.int4i_matmul_plain, "int4ig": quant.int4i_matmul_plain,
         "int4": quant.int4_matmul_plain, "int4g": quant.int4g_matmul_plain}


def _legal(plan, m, k, n, g, layout):
    rows = k // 2
    assert plan.tile == quant.GEMV_TILE_N
    if m > quant.SPLITK_MAX_M:
        assert plan.splits == 0
        return
    assert plan.mt == quant.SPLITK_MAX_M == 16       # the MMA's rows
    assert 1 <= plan.splits <= quant.SPLITK_MAX_SPLITS
    assert plan.splits * plan.span >= rows > (plan.splits - 1) * plan.span
    if g:
        gs = k // g                        # input rows a group
        unit = gs // 2 if layout == I4 else gs
        assert plan.span % unit == 0
        if layout == K4:                   # the high half's groups G/2 + r/gs
            assert (rows // gs) * 2 == g


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 63, 255])
@pytest.mark.parametrize("k,n", DECODE)
@pytest.mark.parametrize("form", list(FORMS))
def test_plan_at_the_decode_shapes(form, k, n, m):
    """Legal at the decode shapes, and a grid of at least one block an SM
    (the tiled kernel above `SPLITK_MAX_M` rows)."""
    layout, grouped = FORMS[form]
    g = k // quant.INT4_GROUP if grouped else 0
    plan = quant.gemv_plan(m, k, n, g, layout, SMS)
    _legal(plan, m, k, n, g, layout)
    if m <= quant.SPLITK_MAX_M:
        assert plan.blocks(m, n) >= SMS, plan


@pytest.mark.parametrize("m", [1, 3, 16])
@pytest.mark.parametrize("k,n", [(64, 200), (192, 200), (320, 200),
                                 (512, 600), (256, 12300)])
@pytest.mark.parametrize("form", list(FORMS))
def test_plan_at_narrow_widths(form, k, n, m):
    """Legal at the narrow trees' widths (`test_matmul_launches_at_any_width`:
    K = 64, 192, 320, groups of 32) and at ragged N."""
    layout, grouped = FORMS[form]
    g = k // 32 if grouped else 0
    plan = quant.gemv_plan(m, k, n, g, layout, SMS)
    _legal(plan, m, k, n, g, layout)


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_plan_aims_at_its_blocks_per_sm(sms):
    """Over every legal slice count, the plan's grid comes nearest (in
    ratio) `SPLITK_BLOCKS_PER_SM` blocks an SM, the fewer slices on a tie;
    the same inputs give the same plan."""
    for k, n in DECODE + ((256, 12300), (192, 200)):
        for m in (1, 2, 8, 16):
            plan = quant.gemv_plan(m, k, n, 0, I4, sms)
            tiles = -(-n // plan.tile)
            rows = k // 2
            want = quant.SPLITK_BLOCKS_PER_SM * sms
            legal = [s for s in range(1, 9) if (s - 1) * -(-rows // s) < rows]
            assert plan.splits == min(
                legal, key=lambda s: (abs(np.log(tiles * s / want)), s))
            assert plan.span == -(-rows // plan.splits)
            quant.gemv_plan.cache_clear()
            assert quant.gemv_plan(m, k, n, 0, I4, sms) == plan


@pytest.mark.parametrize("form", list(FORMS))
def test_the_sweep_times_the_legal_slice_counts(form):
    """The sweep behind `SPLITK_BLOCKS_PER_SM`
    (`probes/gemv_splitk_sweep.py`) times every legal slice count of each
    decode shape, and the plan is one of them."""
    layout, grouped = FORMS[form]
    assert form in gemv_splitk_sweep.FORMS
    for _, k, n, _, _ in gemv_splitk_sweep.CASES:
        g = k // quant.INT4_GROUP if grouped else 0
        slices = quant.splitk_slices(k, g, layout)
        for s, span in slices:
            _legal(quant.GemvPlan(s, 16, quant.GEMV_TILE_N, span), 1, k, n, g,
                   layout)
        for m in gemv_splitk_sweep.ROWS:
            plan = quant.gemv_plan(m, k, n, g, layout, SMS)
            assert (plan.splits, plan.span) in slices


def _emulate(x, w, plan, pre_norm=None, residual=None):
    """The split-K kernel's arithmetic, f32 out: slice partials in rank
    order, then the scale (per channel) and the residual."""
    k = x.shape[-1]
    rows = k // 2
    layout = quant.LAYOUTS[type(w)]
    grouped = isinstance(w, quant.GROUPED)
    xs = x if pre_norm is None else rms_norm(x, *pre_norm)
    xs = xs.float()
    lv = quant.levels(w).float()                       # (K, N) in row order
    if grouped:
        g = w.scale.shape[0]
        lv = (lv.reshape(g, k // g, -1) * w.scale[:, None, :]).reshape(k, -1)
        lv = lv.to(torch.bfloat16).float()
    total = torch.zeros(x.shape[0], lv.shape[1])
    for s in range(plan.splits):
        r0, r1 = s * plan.span, min(rows, (s + 1) * plan.span)
        idx = (torch.arange(2 * r0, 2 * r1) if layout == I4 else
               torch.cat([torch.arange(r0, r1), torch.arange(rows + r0, rows + r1)]))
        total = total + xs[:, idx] @ lv[idx]
    if not grouped:
        total = total * w.scale
    if residual is not None:
        total = total + residual.float()
    return total


def _inputs(form, k, n, m, group, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    layout, grouped = FORMS[form]
    if form == "int4g":
        c = quant.quantize4_grouped(w, group)
    elif form == "int4":
        c = quant.quantize4(w)
    else:
        c = quant.to_interleaved(quant.quantize4_grouped(w, group) if grouped
                                 else quant.quantize4(w))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)
    nw = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(k).astype(
        np.float32)).to(torch.bfloat16)
    res = torch.from_numpy(0.1 * rng.standard_normal((m, n)).astype(
        np.float32)).to(torch.bfloat16)
    return c, x, nw, res


def _jax(a):
    return jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("folds", ["plain", "norm+res"])
@pytest.mark.parametrize("k,n,m,group", [(256, 300, 1, 64), (512, 640, 2, 128),
                                         (256, 1000, 16, 32)])
@pytest.mark.parametrize("form", list(FORMS))
def test_split_sum_matches_jax_and_the_twin(form, k, n, m, group, folds):
    c, x, nw, res = _inputs(form, k, n, m, group, seed=k + n + m)
    layout, grouped = FORMS[form]
    g = c.scale.shape[0] if grouped else 0
    plan = quant.gemv_plan(m, k, n, g, layout, SMS)
    assert plan.splits > 1                 # a real split at these shapes
    pre_norm = (nw, 1e-5) if folds == "norm+res" else None
    residual = res if folds == "norm+res" else None
    emu = _emulate(x, c, plan, pre_norm, residual)

    jfn = JAX_FNS[form]
    kw = dict(out_dtype=jnp.float32)
    if pre_norm is not None:
        kw["pre_norm"] = (_jax(nw), 1e-5)
        kw["residual"] = _jax(res)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn(_jax(x), jnp.asarray(c.values.numpy()),
                             jnp.asarray(c.scale.numpy()), **kw))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())

    twin = TWINS[form](x, c.values, c.scale, pre_norm=pre_norm,
                       residual=residual)
    tol = (2.0 ** -7 if grouped and residual is None else 2e-2) * \
        twin.float().abs().max().item()
    assert (emu.to(torch.bfloat16).float() - twin.float()).abs().max().item() <= tol
