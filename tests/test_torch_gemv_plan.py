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

The fused SwiGLU (row 2, `csrc/fused_swiglu.cu`) runs the same kernel twice
at decode: pass 1 over the column tiles of W1 and then W2 (the plan of an
N = 2 I GEMV), pass 2 over W3 in its layout, which adds the int8 and
column-packed layouts (rows in pairs, steps of 16 rows). Its plan
(`fused_mlp.swiglu_plan`) must be legal for both passes, and an emulation
of its sums (pass-1 split sums in f32, the scales, h = bf16(silu(a) * b),
pass-2 split sums, the residual) is held to JAX's `fused_swiglu` in
interpret mode and to the twin.

The fused QKV step (row 3, `csrc/qkv_rope.cu`) runs it at decode in a QKV
mode: the GEMV's plan over N = (H + 2G) hd columns, tiles of two 32-column
runs hd/2 apart, so that each RoPE pair meets in one cluster. The column
map and the pair epilogue are checked in pure Python at the model's widths
(every output written once, each pair in one tile and one thread), and an
emulation of its sums (split sums, the scale, the rotation by pair, one
cast) is held to JAX's `qkv_rope_step` in interpret mode and to the twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.ops import fused_mlp as jfused
from uniaudio2_tpu.ops import qkv_step as jqkv
from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch.ops import _cuda, fused_mlp, qkv_step, quant
from uniaudio2_tpu_torch.ops.norms import rms_norm
from uniaudio2_tpu_torch.probes import gemv_splitk_sweep, qkv_splits_sweep, splitk_ab

SMS = 132                                  # an H100 SXM
I4, K4 = quant.LAYOUT_I4, quant.LAYOUT_K4
INT8, C4 = quant.LAYOUT_INT8, quant.LAYOUT_C4
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
    if layout in (INT8, C4):               # pairs of rows, whole steps of 16
        assert plan.span % quant.SPLITK_STEP == 0
        if g:
            assert plan.span % ((k // g) // 2) == 0
        return
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


def _split_sum(xs, w, plan):
    """The split-K kernel's sum of f32 activations ``xs`` against ``w``:
    slice partials in rank order, then the scale (per channel). A slice of
    (pair) rows [r0, r1) holds input rows [2 r0, 2 r1) (interleaved; int8
    and column-packed, whose pair r is rows 16 (r / 8) + r % 8 and 8
    below, in whole steps of 16) or [r0, r1) and K/2 + [r0, r1)
    (K-split)."""
    k = xs.shape[-1]
    rows = k // 2
    grouped = isinstance(w, quant.GROUPED)
    lv = quant.levels(w).float()                       # (K, N) in row order
    if grouped:
        g = w.scale.shape[0]
        lv = (lv.reshape(g, k // g, -1) * w.scale[:, None, :]).reshape(k, -1)
        lv = lv.to(torch.bfloat16).float()
    total = torch.zeros(xs.shape[0], lv.shape[1])
    for s in range(plan.splits):
        r0, r1 = s * plan.span, min(rows, (s + 1) * plan.span)
        idx = (torch.cat([torch.arange(r0, r1), torch.arange(rows + r0, rows + r1)])
               if quant.LAYOUTS[type(w)] == K4 else torch.arange(2 * r0, 2 * r1))
        total = total + xs[:, idx] @ lv[idx]
    return total if grouped else total * w.scale


def _emulate(x, w, plan, pre_norm=None, residual=None):
    """The split-K kernel's arithmetic, f32 out: `_split_sum` of the
    (normalised) activations, then the residual."""
    xs = x if pre_norm is None else rms_norm(x, *pre_norm)
    total = _split_sum(xs.float(), w, plan)
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


# The fused SwiGLU's forms, as the serving trees hold them: gate / up and down
SWIGLU_FORMS = {"int4i+int4i": ("int4i", "int4i"),
                "int4ig+int4ig": ("int4ig", "int4ig"),
                "int4+int4c": ("int4", "int4c"), "int4g+int4cg": ("int4g", "int4cg"),
                "int8+int8": ("int8", "int8")}
LAYOUT_OF = {"int4i": I4, "int4ig": I4, "int4": K4, "int4g": K4, "int8": INT8,
             "int4c": C4, "int4cg": C4}
# (K, I, N): the backbone's and the decoder's MLPs
SWIGLU_WIDTHS = ((3072, 8192, 3072), (2048, 8192, 2048))


def _swiglu_groups(form, k, i, group=quant.INT4_GROUP):
    up, down = SWIGLU_FORMS[form]
    return (k // group if up.endswith("g") else 0,
            i // group if down.endswith("g") else 0)


@pytest.mark.parametrize("m", [1, 2, 8, 16])
@pytest.mark.parametrize("k,i,n", SWIGLU_WIDTHS)
@pytest.mark.parametrize("form", list(SWIGLU_FORMS))
def test_swiglu_plan_at_the_decode_shapes(form, k, i, n, m):
    """Up to 16 rows both passes are split-K plans: pass 1 the plan of an
    N = 2 I GEMV in gate / up's layout, pass 2 W3's; each legal, each grid
    at least one block an SM, or the most slices a cluster holds (the
    decoder's column-packed W3: 16 tiles of 128 outputs x 8)."""
    up, down = SWIGLU_FORMS[form]
    g12, g3 = _swiglu_groups(form, k, i)
    plan = fused_mlp.swiglu_plan(m, k, i, n, g12, LAYOUT_OF[up], g3,
                                 LAYOUT_OF[down], SMS)
    assert plan.kind == "splitk"
    assert plan.up == quant.gemv_plan(m, k, 2 * i, g12, LAYOUT_OF[up], SMS)
    assert plan.down == quant.gemv_plan(m, i, n, g3, LAYOUT_OF[down], SMS)
    _legal(plan.up, m, k, 2 * i, g12, LAYOUT_OF[up])
    _legal(plan.down, m, i, n, g3, LAYOUT_OF[down])
    width = n - n // 2 if LAYOUT_OF[down] == C4 else n
    assert plan.up.blocks(m, 2 * i) >= SMS
    assert (plan.down.blocks(m, width) >= SMS
            or plan.down.splits == quant.SPLITK_MAX_SPLITS)


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", [(256, 320), (512, 600), (8192, 3072),
                                 (768, 130)])
@pytest.mark.parametrize("layout", [INT8, C4])
def test_plan_of_the_pair_layouts(layout, k, n, m):
    """The int8 and column-packed plans, per channel and (column-packed)
    with groups of 16-128 rows, are legal at the fused SwiGLU's narrow and
    served down-projection widths."""
    for g in [0] + ([k // gs for gs in (16, 32, 64, 128) if k % gs == 0]
                    if layout == C4 else []):
        _legal(quant.gemv_plan(m, k, n, g, layout, SMS), m, k, n, g, layout)


@pytest.mark.parametrize("scratch", [True, False])
@pytest.mark.parametrize("form", list(FORMS))
def test_splitk_ab_calls_each_build_with_its_own_arguments(form, scratch,
                                                         monkeypatch):
    """`probes/splitk_ab.py` launches another checkout's entry point with
    the arguments that build takes: the plan, then the tile kernel's
    scratch pointer (NULL) only where the entry point has one, then the
    stream."""
    name = gemv_splitk_sweep.ENTRY[form]
    sig = _cuda._SIGNATURES[name]
    calls = []

    class Entry:
        argtypes = sig if scratch else sig[:-2] + sig[-1:]

        def __call__(self, *args):
            calls.append(args)
            return 0

    lib = type("Lib", (), {name: Entry()})()
    monkeypatch.setattr(splitk_ab._cuda, "stream_of", lambda t: 7)
    layout, grouped = FORMS[form]
    w, x, _, _ = _inputs(form, 256, 128, 2, 64, 3)
    plan = quant.gemv_plan(2, 256, 128, w.scale.shape[0] if grouped else 0,
                           layout, SMS)
    splitk_ab.launch(lib, form, w, x, plan, None,
                     torch.empty((2, 128), dtype=torch.bfloat16))
    (args,) = calls
    assert len(args) == len(Entry.argtypes) and args[-1] == 7
    assert args[13:16] == (plan.splits, plan.mt, plan.span)
    assert (len(args) == 18) == scratch and (not scratch or args[16] is None)


@pytest.mark.parametrize("rows", [2, 4, 8, 16, 32, 64, 128])
def test_can_fuse_takes_whole_steps_of_w3_groups(rows):
    """A column-packed grouped W3 is fused only with groups of whole steps
    of 16 rows, which the split-K pass 2 reads under one scale: smaller
    groups (which the JAX package fuses) take the unfused GEMVs, and a
    direct plan for them raises."""
    rng = np.random.default_rng(rows)
    k, i, n = 256, 256, 320

    def rand(*shape):
        return torch.from_numpy((0.02 * rng.standard_normal(shape)).astype(
            np.float32))

    w1, w2 = quant.quantize4(rand(k, i)), quant.quantize4(rand(k, i))
    w3 = quant.quantize4_cols_grouped(rand(i, n), rows)
    x = torch.zeros((1, k), dtype=torch.bfloat16)
    assert fused_mlp.can_fuse(w1, w2, w3, x) == (rows % 16 == 0)
    assert fused_mlp.can_fuse(w1, w2, quant.quantize4_cols(rand(i, n)), x)
    if rows % 16:
        with pytest.raises(ValueError):
            fused_mlp.swiglu_plan(1, k, i, n, 0, K4, i // rows, C4, SMS)
    else:
        assert fused_mlp.swiglu_plan(1, k, i, n, 0, K4, i // rows, C4,
                                     SMS).kind == "splitk"


def _container(form, w, group):
    if form == "int8":
        return quant.quantize(w)
    if form in ("int4c", "int4cg"):
        return (quant.quantize4_cols_grouped(w, group) if form == "int4cg"
                else quant.quantize4_cols(w))
    c = quant.quantize4_grouped(w, group) if form.endswith("g") else \
        quant.quantize4(w)
    return quant.to_interleaved(c) if form in ("int4i", "int4ig") else c


def _to_jax(c):
    return getattr(jq, type(c).__name__)(jnp.asarray(c.values.numpy()),
                                         jnp.asarray(c.scale.numpy()))


def _emulate_swiglu(x, w1, w2, w3, plan, norm_w=None, residual=None):
    """The two split-K passes' arithmetic, f32 out: pass 1's split sums of
    the normalised rows (the twin's bf16 rounding) against W1 and W2 with
    their scales, kept in f32; h = bf16(a / (1 + exp(-a)) * b); pass 2's
    split sums of h against W3, then the residual."""
    xs = (x if norm_w is None else rms_norm(x, norm_w, 1e-5)).float()
    a, b = _split_sum(xs, w1, plan.up), _split_sum(xs, w2, plan.up)
    h = (a / (1.0 + torch.exp(-a)) * b).to(torch.bfloat16).float()
    out = _split_sum(h, w3, plan.down)
    return out if residual is None else out + residual.float()


@pytest.mark.parametrize("folds", ["plain", "norm+res"])
@pytest.mark.parametrize("form", list(SWIGLU_FORMS))
def test_swiglu_split_sums_match_jax_and_the_twin(form, folds):
    """The emulation of the two split-K passes against JAX's fused
    `fused_swiglu` (the Pallas kernel in interpret mode, bf16 in and out,
    with the same folds) and the port's twin (`fused_swiglu_plain`, the XLA
    fallback's rounding). Against JAX the f32 sums of a, b and the output
    run in another order, so a few h may round to the other side (one bf16
    ulp, 2^-8 x |h|), the normalised rows too (see
    tests/test_torch_tc_plan.py), and JAX rounds its output to bf16: within
    2^-7 x max|ref|, one bf16 ulp of the output's range. Against the twin,
    which rounds a, b and every scaled weight to bf16: 2e-2 x max|twin|,
    the card's bound for the fused kernel."""
    up, down = SWIGLU_FORMS[form]
    k, i, n, m, group = 256, 512, 320, 16 if folds == "plain" else 5, 64
    rng = np.random.default_rng(len(form) + m)

    def rand(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32))

    w1, w2 = (_container(up, rand(k, i, std=0.02), group) for _ in range(2))
    w3 = _container(down, rand(i, n, std=0.02), group)
    x = rand(m, k).to(torch.bfloat16)
    kw = {}
    if folds == "norm+res":
        kw = dict(norm_w=(1.0 + 0.1 * rand(k)).to(torch.bfloat16),
                  residual=(0.1 * rand(m, n)).to(torch.bfloat16))
    g12 = w1.scale.shape[0] if w1.scale.ndim == 2 else 0
    g3 = w3.scale.shape[0] if w3.scale.ndim == 2 else 0
    plan = fused_mlp.swiglu_plan(m, k, i, n, g12, LAYOUT_OF[up], g3,
                                 LAYOUT_OF[down], SMS)
    assert plan.kind == "splitk" and plan.down.splits > 1
    emu = _emulate_swiglu(x, w1, w2, w3, plan, **kw)

    jkw = {key: _jax(v) for key, v in kw.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfused.fused_swiglu(
            _jax(x), _to_jax(w1), _to_jax(w2), _to_jax(w3), norm_eps=1e-5,
            **jkw)).astype(np.float32)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())
    twin = fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw)
    tol = 2e-2 * twin.float().abs().max().item()
    assert (emu.to(torch.bfloat16).float() - twin.float()).abs().max().item() <= tol


# The fused QKV step (row 3, `csrc/qkv_rope.cu`) at decode: the split-K
# kernel's QKV mode over W (N = (H + 2G) hd: q's heads, k's, v's). A tile's
# 64 byte columns are columns hd h + 32 p + [0, 32) and the same plus hd/2
# (tile x: head h = x / (hd / 64), p = x % (hd / 64)), so tile columns c and
# c + 32 are a RoPE pair; rank r of the cluster finishes pairs r, r + S, ...
# (pair i: row i / 32, tile column i % 32) with its 128 threads, EPQ = 4
# pairs a thread. The two helpers below mirror the kernel's index
# arithmetic.
QKV_WIDTHS = {"backbone": (3072, 24, 8, 128), "decoder": (2048, 32, 8, 64)}
QKV_FORMS = {"int4i": I4, "int4ig": I4, "int4": K4, "int4g": K4, "int8": INT8}


def _qkv_tile_columns(tile, hd):
    """W's column of each of tile ``tile``'s 64 columns (the kernel's
    `wcol`)."""
    head, p = divmod(tile, hd // 64)
    qa = hd * head + 32 * p
    return [qa + c + (hd // 2 - 32 if c >= 32 else 0) for c in range(64)]


def _qkv_stores(n_head, n_groups, hd, rows, splits, threads=128):
    """Every store of the kernel's QKV epilogue: (stream, row, column of the
    stream, tile, tile column, rank, thread)."""
    stores = []
    for tile in range((n_head + 2 * n_groups) * hd // 64):
        head, j0 = tile // (hd // 64), 32 * (tile % (hd // 64))
        if head < n_head:
            stream, dcol = "q", head * hd
        elif head < n_head + n_groups:
            stream, dcol = "k", (head - n_head) * hd
        else:
            stream, dcol = "v", (head - n_head - n_groups) * hd
        for rank in range(splits):
            for tid in range(threads):
                for k in range(16 * 32 // threads):
                    i = rank + splits * (tid + k * threads)
                    if i >= rows * 32:
                        continue
                    m, c = divmod(i, 32)
                    for h in (0, 1):
                        stores.append((stream, m, dcol + j0 + c + h * hd // 2,
                                       tile, c + 32 * h, rank, tid))
    return stores


@pytest.mark.parametrize("m", [1, 2, 8, 16])
@pytest.mark.parametrize("width", list(QKV_WIDTHS))
@pytest.mark.parametrize("form", list(QKV_FORMS))
def test_qkv_plan_at_the_decode_shapes(form, width, m):
    """The QKV mode's plan (`gemv_plan` capped at `QKV_MAX_SPLITS`) at the
    model's widths: legal, one of the slice counts
    `probes/qkv_splits_sweep.py` times at that case, and the card filled
    (80 or 48 column tiles x 4 slices: 320 and 192 blocks on 132 SMs)."""
    k, h, g, hd = QKV_WIDTHS[width]
    n, layout = (h + 2 * g) * hd, QKV_FORMS[form]
    groups = k // quant.INT4_GROUP if form.endswith("g") else 0
    plan = quant.gemv_plan(m, k, n, groups, layout, SMS,
                           qkv_step.QKV_MAX_SPLITS)
    _legal(plan, m, k, n, groups, layout)
    assert plan.splits == qkv_step.QKV_MAX_SPLITS == 4
    assert (plan.splits, plan.span) in quant.splitk_slices(k, groups, layout)
    assert form in qkv_splits_sweep.FORMS and m in qkv_splits_sweep.ROWS
    assert (width, k, h, g, hd) in qkv_splits_sweep.WIDTHS
    assert plan.blocks(m, n) >= SMS


@pytest.mark.parametrize("rows,splits", [(1, 4), (2, 6), (16, 1), (16, 8)])
@pytest.mark.parametrize("width", list(QKV_WIDTHS))
def test_qkv_tiles_hold_whole_rope_pairs(width, rows, splits):
    """The QKV mode's column map and pair epilogue at the model's widths:
    every column of q, k and v is written exactly once for every row, by the
    tile whose W column it is; the two columns of each RoPE pair (j and
    j + hd/2 of a head) come from one tile and are written by one thread of
    one rank, which holds both; every rank of a tile's cluster has work."""
    _, h, g, hd = QKV_WIDTHS[width]
    stores = _qkv_stores(h, g, hd, rows, splits)
    keys = [(s, m, col) for s, m, col, *_ in stores]
    assert len(keys) == len(set(keys))
    want = {(s, m, col) for s, heads in (("q", h), ("k", g), ("v", g))
            for m in range(rows) for col in range(heads * hd)}
    assert set(keys) == want
    base = {"q": 0, "k": h * hd, "v": (h + g) * hd}
    by_pair = {}
    for s, m, col, tile, c, rank, tid in stores:
        assert _qkv_tile_columns(tile, hd)[c] == base[s] + col
        head_col = col % hd
        pair = (s, m, col - head_col + head_col % (hd // 2))
        by_pair.setdefault(pair, set()).add((tile, rank, tid))
    assert all(len(who) == 1 for who in by_pair.values())
    assert len(by_pair) == len(want) // 2
    ranks = {(tile, rank) for *_, tile, _, rank, _ in stores}
    assert len(ranks) == (h + 2 * g) * hd // 64 * min(splits, rows * 32)


def _emulate_qkv(x, w, norm_w, cos, sin, n_head, n_groups, hd, plan):
    """The QKV mode's arithmetic: `_split_sum` of the normalised rows (the
    twin's bf16 rounding), the per-channel scale, then tile by tile each
    RoPE pair (tile columns c, c + 32) rotated in f32 as the kernel does
    (y cos + rot sin, each product rounded, then the sum), v not; one cast
    to bf16; q, k, v."""
    y = _split_sum(rms_norm(x, norm_w, 1e-5).float(), w, plan)
    out = y.clone()
    for tile in range((n_head + 2 * n_groups) * hd // 64):
        if tile // (hd // 64) >= n_head + n_groups:
            continue                                   # v: not rotated
        cols = _qkv_tile_columns(tile, hd)
        a, b = torch.tensor(cols[:32]), torch.tensor(cols[32:])
        ja, jb = a % hd, b % hd
        out[:, a] = y[:, a] * cos[ja] + (-y[:, b]) * sin[ja]
        out[:, b] = y[:, b] * cos[jb] + y[:, a] * sin[jb]
    out = out.to(torch.bfloat16)
    q_cols, kv_cols = n_head * hd, n_groups * hd
    return (out[:, :q_cols], out[:, q_cols:q_cols + kv_cols],
            out[:, q_cols + kv_cols:])


@pytest.mark.parametrize("heads,m", [((4, 4, 128), 3), ((8, 8, 64), 16)])
@pytest.mark.parametrize("form", list(QKV_FORMS))
def test_qkv_split_sums_match_jax_and_the_twin(form, heads, m):
    """The emulation of the QKV mode (split sums in rank order, the scale,
    the rotation by pair, one cast) at K = 256 and N = 1536 (backbone-like
    hd 128 and decoder-like hd 64 heads, each stream whole chunks of the
    JAX kernel's 512 columns) against JAX's `qkv_rope_step` (the Pallas
    kernel in interpret mode, bf16 out) and the port's twin
    (`qkv_rope_step_plain`, the XLA fallback's rounding: q, k, v rounded
    to bf16 before the rotation). Against JAX the f32 sums run in another
    order and the normalised rows may round to the other side (see
    tests/test_torch_tc_plan.py): within 2^-7 x max|ref|, one bf16 ulp of
    the range. Against the twin: 2e-2 x max|twin|, the card's bound for
    the kernel."""
    h, g, hd = heads
    k, n, group = 256, (h + 2 * g) * hd, 64
    rng = np.random.default_rng(len(form) * 7 + m)
    w = _container(form, torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.02).astype(np.float32)), group)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)
    nw = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(k)).astype(
        np.float32)).to(torch.bfloat16)
    ang = rng.uniform(0.0, 6.0, hd // 2).astype(np.float32)
    cos = torch.from_numpy(np.cos(np.concatenate([ang, ang])))
    sin = torch.from_numpy(np.sin(np.concatenate([ang, ang])))
    grouped = w.scale.ndim == 2
    plan = quant.gemv_plan(m, k, n, w.scale.shape[0] if grouped else 0,
                           QKV_FORMS[form], SMS, qkv_step.QKV_MAX_SPLITS)
    assert plan.splits > 1                 # a real split at these shapes
    emu = _emulate_qkv(x, w, nw, cos, sin, h, g, hd, plan)

    with pltpu.force_tpu_interpret_mode():
        ref = jqkv.qkv_rope_step(_jax(x), _to_jax(w), _jax(nw), 1e-5,
                                 jnp.asarray(cos.numpy()),
                                 jnp.asarray(sin.numpy()), h, g, hd)
    twin = qkv_step.qkv_rope_step_plain(x, w, nw, 1e-5, cos, sin, h, g, hd)
    for e, r, t in zip(emu, ref, twin):
        r = np.asarray(r).astype(np.float32)
        np.testing.assert_allclose(e.float().numpy(), r, rtol=0,
                                   atol=2.0 ** -7 * np.abs(r).max())
        tol = 2e-2 * t.float().abs().max().item()
        assert (e.float() - t.float()).abs().max().item() <= tol
