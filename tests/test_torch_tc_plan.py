"""The tensor-core tile kernel of rows 7 and 8 (`csrc/gemv_int4_tc.cuh`, the
column-packed int4 GEMVs above 16 rows): its host plan (`quant.tc_plan`)
and, on the CPU, a plain emulation of the plan's fixed-order split sum.

The plan is a function of the shape and the SM count only. It sends up to
16 rows, K not a multiple of 8 and groups of K/G rows that are not a whole
number of k-steps of 16 to the tiled kernel; above that its tiles cover
the output exactly (BC byte columns a block: columns c and N/2 + c; BN
activation rows, the constants read from the kernel's source), its 1-8
K-slices cover K with none empty, each a whole number of BK-row stages
and of scale groups, its clusters fit in one wave (`quant.tc_wave`: fewer
blocks an SM in clusters of three or more) unless a single slice does
not, no further slice would, and
at the model's prefill shapes its grid on 132 SMs is the one the
docstring states.

The emulation adds, slice by slice in rank order, the f32 products of the
activations with the levels (per channel: unscaled, the scale on the f32
sum; grouped: level x scale rounded to bf16). It is held
 * to JAX's `_pallas_int4c_matmul` / `_pallas_int4cg_matmul` in interpret
   mode with f32 output (no folds: the Pallas kernels have none): the same
   arithmetic in another order of f32 sums, within 1e-5 x max|ref|;
 * to the port's plain twins (`int4c_matmul_plain` / `int4cg_matmul_plain`
   through `matmul_plain`, the XLA fallback's rounding, bf16 output):
   within 2e-2 x max|twin| per channel, one bf16 ulp, 2^-7 x max|twin|,
   grouped.

The same holds below for the row-packed and int8 instances (rows 1, 4, 5
and 6 above 16 rows) and for the fused SwiGLU's two tile passes (row 2 at
17-128 rows): their plans (a K-split tree gets its interleaved copy's, in
both passes) and an emulation of their sums against JAX's `fused_swiglu`
in interpret mode and the twin, with the tolerances each test states.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.ops import fused_mlp as jfused
from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch.ops import fused_mlp, quant
from uniaudio2_tpu_torch.ops.norms import rms_norm

SMS = 132                                  # an H100 SXM
# (K, N) of the MLP down-projections, the narrow trees' widths, ragged N
SHAPES = ((8192, 3072), (8192, 2048), (512, 600), (64, 200), (192, 200),
          (320, 200), (520, 37), (100, 300))
ROWS = (1, 16, 17, 63, 64, 65, 128, 129, 255, 256, 257, 510)


def _groups(k):
    """0 (per channel) and every G whose group of K/G rows is one of 8-128."""
    return [0] + [k // gs for gs in (8, 16, 32, 48, 64, 128) if k % gs == 0]


def _legal(plan, m, k, n, g):
    gs = k // g if g else 0
    if m <= quant.SPLITK_MAX_M or k % 8 or (g and gs % 16):
        assert plan.splits == 0
        return
    lay = quant.tc_layout()
    cols, splits, rows = plan.grid(m, n)
    width = n - n // 2                     # byte columns in use
    assert cols * lay.bc >= width > (cols - 1) * lay.bc
    assert rows * lay.bn >= m > (rows - 1) * lay.bn
    assert 1 <= splits == plan.splits <= lay.max_splits
    assert plan.span % lay.bk == 0
    assert plan.splits * plan.span >= k > (plan.splits - 1) * plan.span
    if g:
        assert plan.span % gs == 0         # scale groups stay whole


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_is_legal(k, n, m):
    for g in _groups(k):
        _legal(quant.tc_plan(m, k, n, g, SMS), m, k, n, g)


@pytest.mark.parametrize("m,k,n,g,plan,blocks", [
    (255, 8192, 3072, 0, (4, 2048), 96),
    (255, 8192, 3072, 64, (4, 2048), 96),
    (510, 8192, 3072, 0, (2, 4096), 96),
    (510, 8192, 3072, 64, (2, 4096), 96),
    (255, 8192, 2048, 0, (6, 1408), 96),
    (510, 8192, 2048, 64, (3, 2816), 96),
])
def test_plan_grid_on_132_sms(m, k, n, g, plan, blocks):
    """The grids `tc_plan`'s docstring states."""
    got = quant.tc_plan(m, k, n, g, SMS)
    assert tuple(got) == plan
    assert got.blocks(m, n) == blocks


def test_layout_is_the_kernels():
    """The constants the plan reads are the tile kernel's: 64 input rows a
    stage, 256 activation rows and 64 byte columns a block, 8 slices."""
    assert tuple(quant.tc_layout()) == (64, 256, 64, 8)


def _fills_one_wave(m, k, n, g, sms, layout):
    """Above 16 rows the plan's clusters fit in one wave of `tc_wave` (S,
    ``sms``) blocks unless one slice a tile already does not, and no larger
    slice count would fit, pass the most a cluster holds, or leave a slice
    empty; the same inputs give the same plan."""
    lay = quant.tc_layout()
    plan = quant.tc_plan(m, k, n, g, sms, layout)
    cols, _, rows = plan.grid(m, n, layout)
    tiles = cols * rows
    assert (plan.blocks(m, n, layout) <= quant.tc_wave(plan.splits, sms)
            or plan.splits == 1)
    group = (2 * k // g if layout == quant.LAYOUT_K4 else k // g) if g else 0
    unit = math.lcm(lay.bk, group) if g else lay.bk
    for more in range(plan.splits + 1, lay.max_splits + 1):
        span = -(-(-(-k // unit)) // more) * unit
        assert (tiles * more > quant.tc_wave(more, sms)
                or -(-k // span) < more)
    quant.tc_plan.cache_clear()
    assert quant.tc_plan(m, k, n, g, sms, layout) == plan


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_plan_fills_one_wave(sms):
    """`_fills_one_wave` at the column-packed shapes; clusters of one or two
    fill every SM, of three or more `TC_BLOCKS_PER_SM` of them."""
    assert quant.tc_wave(2, sms) == int(quant.TC_PAIR_BLOCKS_PER_SM * sms)
    assert quant.tc_wave(3, sms) == int(quant.TC_BLOCKS_PER_SM * sms)
    for k, n in SHAPES[:3]:
        for m in (17, 63, 255, 510):
            for g in (0, k // 64):
                _fills_one_wave(m, k, n, g, sms, quant.LAYOUT_C4)


def _emulate(x, w, plan):
    """The tile kernel's arithmetic, f32 out: slice partials in rank order,
    then the scale (per channel)."""
    k = x.shape[-1]
    grouped = isinstance(w, quant.GROUPED)
    xs = x.float()
    lv = quant.levels(w).float()                       # (K, N)
    if grouped:
        g = w.scale.shape[0]
        lv = (lv.reshape(g, k // g, -1) * w.scale[:, None, :]).reshape(k, -1)
        lv = lv.to(torch.bfloat16).float()
    total = torch.zeros(x.shape[0], lv.shape[1])
    for s in range(plan.splits):
        k0, k1 = s * plan.span, min(k, (s + 1) * plan.span)
        total = total + xs[:, k0:k1] @ lv[k0:k1]
    if not grouped:
        total = total * w.scale
    return total


def _inputs(grouped, k, n, m, group, seed):
    """A column-packed weight (quantized at even N; at odd N, which the
    quantizers refuse but the kernels take, random bytes in a storage 64
    bytes wider than ceil(N/2) and random scales), x, a norm weight and a
    residual."""
    rng = np.random.default_rng(seed)
    if n % 2:
        ldw = -(-(n - n // 2) // 64) * 64 + 64
        values = torch.from_numpy(rng.integers(-128, 128, (k, ldw), dtype=np.int8))
        shape = (k // group, n) if grouped else (n,)
        scale = torch.from_numpy(
            (0.002 + 0.002 * rng.random(shape)).astype(np.float32))
        c = (quant.QuantizedLinearC4G if grouped else quant.QuantizedLinearC4)(
            values, scale)
    else:
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
        c = (quant.quantize4_cols_grouped(w, group) if grouped
             else quant.quantize4_cols(w))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)
    nw = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(k).astype(
        np.float32)).to(torch.bfloat16)
    res = torch.from_numpy(0.1 * rng.standard_normal((m, n)).astype(
        np.float32)).to(torch.bfloat16)
    return c, x, nw, res


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("k,n,m,group", [(1024, 300, 17, 64),
                                         (768, 601, 40, 128),
                                         (2048, 256, 130, 32)])
def test_split_sum_matches_jax_and_the_twin(grouped, k, n, m, group):
    c, x, _, _ = _inputs(grouped, k, n, m, group, seed=k + n + m)
    g = c.scale.shape[0] if grouped else 0
    plan = quant.tc_plan(m, k, n, g, SMS)
    assert plan.splits > 1                 # a real split at these shapes
    emu = _emulate(x, c, plan)
    jfn = jq._pallas_int4cg_matmul if grouped else jq._pallas_int4c_matmul
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(c.values.numpy()),
                             jnp.asarray(c.scale.numpy()),
                             out_dtype=jnp.float32))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    twin = quant.matmul_plain(x, c)
    tol = (2.0 ** -7 if grouped else 2e-2) * twin.float().abs().max().item()
    assert (emu.to(torch.bfloat16).float()
            - twin.float()).abs().max().item() <= tol


def test_wrappers_take_the_twin_on_the_cpu():
    """On CPU tensors the column-packed wrappers (f32 output) and their
    tiled yardsticks (with every fold) return the twin, and count no
    launch."""
    c, x, nw, res = _inputs(False, 512, 600, 63, 64, seed=3)
    cg, *_ = _inputs(True, 512, 600, 63, 64, seed=4)
    for fn, tiled, w in ((quant.int4c_matmul, quant.int4c_matmul_tiled, c),
                         (quant.int4cg_matmul, quant.int4cg_matmul_tiled, cg)):
        before = (fn.launches, tiled.launches)
        f32 = quant.matmul_plain(x, w, out_dtype=torch.float32)
        assert torch.equal(fn(x, w.values, w.scale, out_dtype=torch.float32),
                           f32)
        kw = dict(pre_norm=(nw, 1e-5), residual=res, out_dtype=torch.float32)
        ref = quant.matmul_plain(x, w, **kw)
        assert torch.equal(tiled(x, w.values, w.scale, **kw), ref)
        assert (fn.launches, tiled.launches) == before


# Rows 1, 4, 5 and 6 above 16 rows: the tile kernel's row-interleaved (I4),
# K-split (K4) and int8 (INT8) instances. The K-split one runs I4's products
# on x' (x[0], x[K/2], x[1], x[K/2 + 1], ...), which its row kernel writes,
# normalised when the call folds a norm; a slice of the plan is a range of
# x' (span / 2 rows of each K half). Int8 reads x as it is (normalised by
# the row kernel for a call with a norm), one level a byte.
I4, K4, INT8 = quant.LAYOUT_I4, quant.LAYOUT_K4, quant.LAYOUT_INT8
# (K, N) of the prefill GEMVs (QKV, attn_proj, gate / up, the interleaved
# down-projection), the narrow trees' widths, ragged N
ROW_SHAPES = ((3072, 5120), (3072, 3072), (3072, 8192), (8192, 3072),
              (512, 600), (256, 300), (192, 200), (1024, 601), (520, 37))


def _row_groups(k, layout):
    """0 and every G whose group of K/G rows is one of 8-128 and, for the
    K-split layout, whose K halves hold whole groups (G even)."""
    return [g for g in _groups(k) if not g or layout == I4 or g % 2 == 0]


def _row_legal(plan, m, k, n, g, layout):
    gs = k // g if g else 0
    if m <= quant.SPLITK_MAX_M or k % 8 or (g and gs % 16):
        assert plan.splits == 0
        return
    lay = quant.tc_layout()
    cols, splits, rows = plan.grid(m, n, layout)
    # one output column a byte column, 2 bc a block: every byte column in
    # use (the true width N) covered, no tile past it
    assert cols * 2 * lay.bc >= n > (cols - 1) * 2 * lay.bc
    assert rows * lay.bn >= m > (rows - 1) * lay.bn
    assert 1 <= splits == plan.splits <= lay.max_splits
    assert plan.span % lay.bk == 0
    assert plan.splits * plan.span >= k > (plan.splits - 1) * plan.span
    if g and layout == I4:
        assert plan.span % gs == 0         # whole groups
    if g and layout == K4:
        # a slice of x' holds span / 2 rows of each K half: whole groups of
        # the low half's [0, G/2) and of the high half's [G/2, G)
        assert (plan.span // 2) % gs == 0


@pytest.mark.parametrize("layout", [I4, K4])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", ROW_SHAPES)
def test_row_plan_is_legal(k, n, m, layout):
    for g in _row_groups(k, layout):
        _row_legal(quant.tc_plan(m, k, n, g, SMS, layout), m, k, n, g, layout)


@pytest.mark.parametrize("layout", [I4, K4])
@pytest.mark.parametrize("m,k,n,g,plan,blocks", [
    (255, 3072, 5120, 0, (2, 1536), 80),
    (255, 3072, 5120, 24, (2, 1536), 80),
    (255, 3072, 3072, 0, (4, 768), 96),
    (255, 3072, 8192, 24, (2, 1536), 128),
    (255, 8192, 3072, 64, (4, 2048), 96),
    (510, 3072, 8192, 0, (1, 3072), 128),
])
def test_row_plan_grid_on_132_sms(m, k, n, g, plan, blocks, layout):
    """The row-packed grids `tc_plan`'s docstring states (128 output
    columns a tile)."""
    got = quant.tc_plan(m, k, n, g, SMS, layout)
    assert tuple(got) == plan
    assert got.blocks(m, n, layout) == blocks


@pytest.mark.parametrize("layout", [I4, K4])
@pytest.mark.parametrize("sms", [132, 114, 78])
def test_row_plan_fills_one_wave(sms, layout):
    """`_fills_one_wave` at the row-packed shapes (128 output columns a
    column tile)."""
    lay = quant.tc_layout()
    for k, n in ROW_SHAPES[:5]:
        for m in (17, 63, 255, 510):
            for g in (0, k // 64):
                assert quant.tc_plan(m, k, n, g, sms, layout).splits == 0 or \
                    quant.tc_plan(m, k, n, g, sms, layout).grid(
                        m, n, layout)[0] == -(-n // (2 * lay.bc))
                _fills_one_wave(m, k, n, g, sms, layout)


def _x_prime(x, layout):
    """The k order the tile kernel reads: x itself (I4, INT8), or x[0],
    x[K/2], x[1], x[K/2 + 1], ... (K4)."""
    if layout != K4:
        return x
    k = x.shape[-1]
    return torch.stack([x[:, :k // 2], x[:, k // 2:]], -1).reshape(x.shape)


def _emulate_rows(x, w, plan, xn=None, residual=None):
    """The row-packed tile kernel's arithmetic, f32 out: the row kernel's
    output ``xn`` (x normalised and rounded to bf16, for a call that folds
    a norm) in its k order, the slices' partials over x' added in rank
    order, then the scale (per channel), then the residual in f32 (the one
    rounding is the caller's)."""
    k = x.shape[-1]
    layout = quant.LAYOUTS[type(w)]
    grouped = isinstance(w, quant.GROUPED)
    xs = x if xn is None else xn
    lv = quant.levels(w).float()                       # (K, N) in x order
    if grouped:
        g = w.scale.shape[0]
        lv = (lv.reshape(g, k // g, -1) * w.scale[:, None, :]).reshape(k, -1)
        lv = lv.to(torch.bfloat16).float()
    xp, lp = _x_prime(xs.float(), layout), _x_prime(lv.T, layout).T
    total = torch.zeros(x.shape[0], lv.shape[1])
    for s in range(plan.splits):
        k0, k1 = s * plan.span, min(k, (s + 1) * plan.span)
        total = total + xp[:, k0:k1] @ lp[k0:k1]
    if not grouped:
        total = total * w.scale
    if residual is not None:
        total = total + residual.float()
    return total


ROW_FORMS = {"int4i": (I4, False), "int4ig": (I4, True), "int4": (K4, False),
             "int4g": (K4, True), "int8": (INT8, False)}
ROW_JAX = {"int4i": jq._pallas_int4i_matmul, "int4ig": jq._pallas_int4i_matmul,
           "int4": jq._pallas_int4_matmul, "int4g": jq._pallas_int4g_matmul,
           "int8": jq._pallas_int8_matmul}


def _row_inputs(form, k, n, m, group, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.02)
    if form == "int8":
        c = quant.quantize(w)
    elif form == "int4g":
        c = quant.quantize4_grouped(w, group)
    elif form == "int4":
        c = quant.quantize4(w)
    else:
        c = quant.to_interleaved(quant.quantize4_grouped(w, group)
                                 if form == "int4ig" else quant.quantize4(w))
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


@pytest.mark.parametrize("folds", ["plain", "norm", "res", "norm+res"])
@pytest.mark.parametrize("k,n,m,group", [(1024, 300, 40, 64),
                                         (768, 601, 130, 128),
                                         (2048, 200, 17, 32)])
@pytest.mark.parametrize("form", list(ROW_FORMS))
def test_row_split_sum_matches_jax_and_the_twin(form, k, n, m, group, folds):
    """The row-packed and int8 emulation against JAX's `_pallas_int4i_matmul`
    / `_pallas_int4_matmul` / `_pallas_int4g_matmul` / `_pallas_int8_matmul`
    in interpret mode (f32 out, with the same folds)
    and the port's twin (bf16 out: 2e-2 x max|twin|, one bf16 ulp grouped
    without a residual), given the twin's normalised rows, as the row
    kernel rounds them. Against JAX the f32 sums differ in order only:
    1e-5 x max|ref|; with a norm the Pallas kernel's rows may differ from
    the twin's by one bf16 ulp in a few elements (their f32 statistics
    differ in the last bit, and XLA's order of the mean follows the row
    block's shape), so the bound adds two such flips of the largest
    product, 2^-7 x max|xn| x max|W|."""
    c, x, nw, res = _row_inputs(form, k, n, m, group, seed=k + n + m)
    layout, grouped = ROW_FORMS[form]
    g = c.scale.shape[0] if grouped else 0
    plan = quant.tc_plan(m, k, n, g, SMS, layout)
    assert plan.splits > 1                 # a real split at these shapes
    pre_norm = (nw, 1e-5) if "norm" in folds else None
    residual = res if "res" in folds else None

    jfn = ROW_JAX[form]
    kw = dict(out_dtype=jnp.float32)
    xn = None
    if pre_norm is not None:
        kw["pre_norm"] = (_jax(nw), 1e-5)
        xn = rms_norm(x, nw, 1e-5)
        xn_jax = np.asarray(jq._maybe_norm(_jax(x), _jax(nw), 1e-5)).astype(
            np.float32)
        assert (np.abs(xn.float().numpy() - xn_jax)
                <= 2.0 ** -7 * np.abs(xn_jax)).all()
    if residual is not None:
        kw["residual"] = _jax(res)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfn(_jax(x), jnp.asarray(c.values.numpy()),
                             jnp.asarray(c.scale.numpy()), **kw))
    emu = _emulate_rows(x, c, plan, xn, residual)
    atol = 1e-5 * np.abs(ref).max()
    if xn is not None:
        atol += 2.0 ** -7 * xn.float().abs().max().item() * \
            quant.dequantize_any(c, torch.float32).abs().max().item()
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0, atol=atol)

    twin = quant.matmul_plain(x, c, pre_norm=pre_norm, residual=residual)
    tol = (2.0 ** -7 if grouped and residual is None else 2e-2) * \
        twin.float().abs().max().item()
    assert (emu.to(torch.bfloat16).float()
            - twin.float()).abs().max().item() <= tol


def test_row_wrappers_take_the_twin_on_the_cpu():
    """On CPU tensors above 16 rows `int4i_matmul` (per channel and
    grouped), `int4_matmul` and `int4g_matmul` return the twin with every
    fold and count no launch, on the wrapper or on the tile kernel's
    counter."""
    cases = [(quant.int4i_matmul, _row_inputs("int4i", 512, 600, 63, 64, 5)),
             (quant.int4i_matmul, _row_inputs("int4ig", 512, 600, 63, 64, 6)),
             (quant.int4_matmul, _row_inputs("int4", 512, 600, 63, 64, 8)),
             (quant.int4g_matmul, _row_inputs("int4g", 512, 600, 63, 64, 7))]
    for fn, (w, x, nw, res) in cases:
        before = (fn.launches, quant.gemv_tc.launches)
        kw = dict(pre_norm=(nw, 1e-5), residual=res, out_dtype=torch.float32)
        assert torch.equal(fn(x, w.values, w.scale, **kw),
                           quant.matmul_plain(x, w, **kw))
        assert (fn.launches, quant.gemv_tc.launches) == before


# The fused SwiGLU (row 2) above 16 rows, up to the 128 `can_fuse` takes
# (the bucket-64 prefill: 63 rows, 126 for a CFG pair): the tile passes,
# in every served form. Pass 1 (`swiglu_tc_kernel`) takes UP_COLS = 64
# columns of W1 and of W2 a block, the interleaved layout's plan over 2 I
# columns in every layout, and sums in x's k order (the K-split layout
# too: the low nibbles of a byte row in the low half of K, the high ones
# in the high half); pass 2 is the tile GEMV of W3's layout over h.
SWIGLU_SERVED = {"int4i+int4i": (I4, I4), "int4ig+int4ig": (I4, I4),
                 "int4+int4c": (K4, quant.LAYOUT_C4),
                 "int4g+int4cg": (K4, quant.LAYOUT_C4),
                 "int8+int8": (quant.LAYOUT_INT8, quant.LAYOUT_INT8)}
# the K-split trees and the interleaved trees of the same levels
SWIGLU_PAIRS = {"int4+int4c": "int4i+int4i", "int4g+int4cg": "int4ig+int4ig"}
SWIGLU_SHAPES = ((3072, 8192, 3072), (2048, 8192, 2048), (512, 1024, 600))


def _swiglu_groups(form, k, i):
    return (k // 128 if form.split("+")[0].endswith("g") else 0,
            i // 128 if form.endswith("g") else 0)


@pytest.mark.parametrize("m", [17, 63, 126, 128])
@pytest.mark.parametrize("k,i,n", SWIGLU_SHAPES)
@pytest.mark.parametrize("form", list(SWIGLU_SERVED))
def test_swiglu_plan_above_the_decode_rows(form, k, i, n, m):
    """Above 16 rows `swiglu_plan` sends every form to the tile passes:
    pass 1 the interleaved layout's `tc_plan` over 2 I columns (64 of W1
    and 64 of W2 a block), pass 2 W3's, both legal plans of the tile
    kernel (`_row_legal`, `_legal`)."""
    up, down = SWIGLU_SERVED[form]
    g12, g3 = _swiglu_groups(form, k, i)
    plan = fused_mlp.swiglu_plan(m, k, i, n, g12, up, g3, down, SMS)
    assert plan == fused_mlp.SwigluPlan(
        "tile", quant.tc_plan(m, k, 2 * i, g12, SMS, I4),
        quant.tc_plan(m, i, n, g3, SMS, down))
    assert plan.up.splits > 0 and plan.down.splits > 0
    _row_legal(plan.up, m, k, 2 * i, g12, I4)
    if g12:
        assert plan.up.span % (k // g12) == 0      # whole groups of x's k
    if down == quant.LAYOUT_C4:
        _legal(plan.down, m, i, n, g3)
    else:
        _row_legal(plan.down, m, i, n, g3, down)


@pytest.mark.parametrize("m", [17, 63, 126, 128])
@pytest.mark.parametrize("k,i,n", SWIGLU_SHAPES[:2])
@pytest.mark.parametrize("pair", list(SWIGLU_PAIRS))
@pytest.mark.parametrize("sms", [132, 114])
def test_swiglu_tile_plans_match_across_byte_orders(pair, k, i, n, m, sms):
    """At every served shape the K-split pass 1 gets the interleaved one's
    (S, span), and the column-packed pass 2 the interleaved one's: the
    same K-slices, so the same sums in the same order."""
    up, down = SWIGLU_SERVED[pair]
    iup, idown = SWIGLU_SERVED[SWIGLU_PAIRS[pair]]
    g12, g3 = _swiglu_groups(pair, k, i)
    assert fused_mlp.swiglu_plan(m, k, i, n, g12, up, g3, down, sms) == \
        fused_mlp.swiglu_plan(m, k, i, n, g12, iup, g3, idown, sms)
    assert quant.tc_plan(m, i, n, g3, sms, quant.LAYOUT_C4) == \
        quant.tc_plan(m, i, n, g3, sms, I4)


def test_swiglu_tile_groups():
    """Groups that are not whole k-steps of 16 rows: `can_fuse` refuses them
    above 16 rows (and takes them at decode), `swiglu_plan` raises."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy((0.02 * rng.standard_normal((256, 512))).astype(
        np.float32))
    w3 = torch.from_numpy((0.02 * rng.standard_normal((512, 256))).astype(
        np.float32))
    for gs12, gs3 in ((8, 128), (128, 8)):
        w1 = quant.to_interleaved(quant.quantize4_grouped(w, gs12))
        d = quant.to_interleaved(quant.quantize4_grouped(w3, gs3))
        assert fused_mlp.can_fuse(w1, w1, d, torch.zeros(16, 256))
        assert not fused_mlp.can_fuse(w1, w1, d, torch.zeros(17, 256))
        with pytest.raises(ValueError):
            fused_mlp.swiglu_plan(17, 256, 512, 256, 256 // gs12, I4,
                                  512 // gs3, I4, SMS)


def _natural_sum(xs, w, plan):
    """The tile kernel's split sum in x's k order, f32: the slices'
    partials in rank order, the per-channel scale on the sum (grouped:
    level x scale rounded to bf16 before the product)."""
    k = xs.shape[-1]
    lv = quant.levels(w).float()
    if isinstance(w, quant.GROUPED):
        g = w.scale.shape[0]
        lv = (lv.reshape(g, k // g, -1) * w.scale[:, None, :]).reshape(k, -1)
        lv = lv.to(torch.bfloat16).float()
    total = torch.zeros(xs.shape[0], lv.shape[1])
    for s in range(plan.splits):
        k0, k1 = s * plan.span, min(k, (s + 1) * plan.span)
        total = total + xs[:, k0:k1].float() @ lv[k0:k1]
    return total if isinstance(w, quant.GROUPED) else total * w.scale


def _emulate_swiglu_tile(x, w1, w2, w3, plan, norm_w=None, residual=None):
    """The two tile passes' arithmetic, f32 out: pass 1's split sums of the
    (normalised, as the row kernel rounds them) rows against W1 and W2 in
    x's k order in every layout, kept in f32, h = bf16(a / (1 + exp(-a))
    * b); pass 2's split sums of h against W3, then the residual."""
    xs = x if norm_w is None else rms_norm(x, norm_w, 1e-5)
    a, b = _natural_sum(xs, w1, plan.up), _natural_sum(xs, w2, plan.up)
    h = (a / (1.0 + torch.exp(-a)) * b).to(torch.bfloat16)
    out = _natural_sum(h, w3, plan.down)
    return out if residual is None else out + residual.float()


SWIGLU_CONTAINERS = {"int4i": lambda w, gs: quant.to_interleaved(quant.quantize4(w)),
                     "int4ig": lambda w, gs: quant.to_interleaved(
                         quant.quantize4_grouped(w, gs)),
                     "int4": lambda w, gs: quant.quantize4(w),
                     "int4g": quant.quantize4_grouped,
                     "int4c": lambda w, gs: quant.quantize4_cols(w),
                     "int4cg": quant.quantize4_cols_grouped,
                     "int8": lambda w, gs: quant.quantize(w)}


def _swiglu_tile_inputs(form, m, seed, k=256, i=512, n=320, group=64):
    rng = np.random.default_rng(seed)

    def rand(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32))

    up, down = form.split("+")
    w1, w2 = (SWIGLU_CONTAINERS[up](rand(k, i, std=0.02), group)
              for _ in range(2))
    w3 = SWIGLU_CONTAINERS[down](rand(i, n, std=0.02), group)
    x = rand(m, k).to(torch.bfloat16)
    folds = dict(norm_w=(1.0 + 0.1 * rand(k)).to(torch.bfloat16),
                 residual=(0.1 * rand(m, n)).to(torch.bfloat16))
    return (w1, w2, w3), x, folds


def _tile_plan(m, w1, w3, x):
    k, i, n = x.shape[-1], w1.scale.shape[-1], w3.scale.shape[-1]
    g12, g3 = (w.scale.shape[0] if w.scale.ndim == 2 else 0 for w in (w1, w3))
    return fused_mlp.swiglu_plan(m, k, i, n, g12, quant.LAYOUTS[type(w1)], g3,
                                 quant.LAYOUTS[type(w3)], SMS)


@pytest.mark.parametrize("folds", ["plain", "norm+res"])
@pytest.mark.parametrize("form", list(SWIGLU_SERVED))
def test_swiglu_tile_passes_match_jax_and_the_twin(form, folds):
    """The emulation of the two tile passes (M = 17 plain, 128 with the
    norm and the residual, a real split in both passes) against JAX's
    `fused_swiglu` (the Pallas kernel in interpret mode, bf16 in and out,
    the same folds) and the port's twin. Against JAX the f32 sums run in
    another order, so a few h may round to the other side (one bf16 ulp),
    the normalised rows too, and JAX rounds its output to bf16: within
    2^-7 x max|ref|. Against the twin, which rounds a, b and every scaled
    weight to bf16: 2e-2 x max|twin|, the card's bound for the fused
    kernel."""
    m = 17 if folds == "plain" else 128
    (w1, w2, w3), x, kw = _swiglu_tile_inputs(form, m, seed=len(form) + m)
    if folds == "plain":
        kw = {}
    plan = _tile_plan(m, w1, w3, x)
    assert plan.kind == "tile" and plan.up.splits > 1 and plan.down.splits > 1
    emu = _emulate_swiglu_tile(x, w1, w2, w3, plan, **kw)

    def to_jax(c):
        return getattr(jq, type(c).__name__)(jnp.asarray(c.values.numpy()),
                                             jnp.asarray(c.scale.numpy()))

    jkw = {key: _jax(v) for key, v in kw.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfused.fused_swiglu(
            _jax(x), to_jax(w1), to_jax(w2), to_jax(w3), norm_eps=1e-5,
            **jkw)).astype(np.float32)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())
    twin = fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw)
    tol = 2e-2 * twin.float().abs().max().item()
    assert (emu.to(torch.bfloat16).float() - twin.float()).abs().max().item() <= tol


@pytest.mark.parametrize("m", [17, 63, 126, 128])
@pytest.mark.parametrize("pair", list(SWIGLU_PAIRS))
def test_swiglu_tile_emulation_matches_across_byte_orders(pair, m):
    """A K-split tree and its interleaved copy (the same levels and scales,
    `quant.to_interleaved`) get one plan and, in the emulation of the tile
    passes, the same bits, with and without the folds."""
    (w1, w2, w3), x, kw = _swiglu_tile_inputs(pair, m, seed=m)
    i1, i2, i3 = (quant.to_interleaved(w) for w in (w1, w2, w3))
    plan = _tile_plan(m, w1, w3, x)
    assert plan == _tile_plan(m, i1, i3, x)
    for folds in ({}, kw):
        assert torch.equal(_emulate_swiglu_tile(x, w1, w2, w3, plan, **folds),
                           _emulate_swiglu_tile(x, i1, i2, i3, plan, **folds))


def test_swiglu_wrappers_take_the_twin_on_the_cpu():
    """On CPU tensors `fused_swiglu` and its tiled yardstick return the
    twin at a decode and a prefill M and count no launch (nor the tile
    passes' counters, `swiglu_tc` and `quant.gemv_tc`)."""
    rng = np.random.default_rng(9)
    w1, w2 = (quant.to_interleaved(quant.quantize4(torch.from_numpy(
        (0.02 * rng.standard_normal((256, 512))).astype(np.float32))))
        for _ in range(2))
    w3 = quant.to_interleaved(quant.quantize4(torch.from_numpy(
        (0.02 * rng.standard_normal((512, 256))).astype(np.float32))))
    nw = torch.ones(256, dtype=torch.bfloat16)
    for m in (1, 63):
        x = torch.from_numpy(rng.standard_normal((m, 256)).astype(
            np.float32)).to(torch.bfloat16)
        fns = (fused_mlp.fused_swiglu, fused_mlp.fused_swiglu_tiled,
               fused_mlp.swiglu_tc, quant.gemv_tc)
        before = [fn.launches for fn in fns]
        ref = fused_mlp.fused_swiglu_plain(x, w1, w2, w3, norm_w=nw, residual=x)
        for fn in fns[:2]:
            assert torch.equal(fn(x, w1, w2, w3, norm_w=nw, residual=x), ref)
        assert [fn.launches for fn in fns] == before


# Row 4 above 16 rows: the tile kernel's INT8 instance, one output column a
# byte column (128 a tile), per-channel scales only.
# (K, N) of int8's prefill GEMVs: attn_proj (backbone and decoder widths),
# the projection, the audio head, the QKV projection, the lm_head; then
# narrow and ragged ones
INT8_SHAPES = ((3072, 3072), (2048, 2048), (3072, 2048), (2048, 12300),
               (3072, 5120), (3072, 128256), (512, 600), (256, 300),
               (520, 37), (100, 300))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", INT8_SHAPES)
def test_int8_plan_is_legal(k, n, m):
    """Legal for int8 (the checks of the row-packed layouts, no groups):
    up to 16 rows and at K % 8 the tiled kernel, else tiles of 128 output
    columns and BN rows over 1-8 slices of whole stages."""
    _row_legal(quant.tc_plan(m, k, n, 0, SMS, INT8), m, k, n, 0, INT8)


@pytest.mark.parametrize("m,k,n,plan,blocks", [
    (63, 3072, 3072, (4, 768), 96),
    (255, 3072, 3072, (4, 768), 96),
    (510, 3072, 3072, (2, 1536), 96),
    (255, 2048, 2048, (6, 384), 96),
    (255, 3072, 2048, (6, 512), 96),
    (255, 2048, 12300, (1, 2048), 97),
    (63, 3072, 5120, (2, 1536), 80),
    (255, 3072, 5120, (2, 1536), 80),
    (510, 3072, 5120, (1, 3072), 80),
    (63, 3072, 128256, (1, 3072), 1002),
])
def test_int8_plan_grid_on_132_sms(m, k, n, plan, blocks):
    """The int8 grids on 132 SMs (128 output columns a tile, as the
    row-packed layouts): the prefill's QKV projection 40 tiles x 2 slices,
    attn_proj 24 x 4, the audio head's 97 tiles and the lm_head's 1,002
    one slice each."""
    got = quant.tc_plan(m, k, n, 0, SMS, INT8)
    assert tuple(got) == plan
    assert got.blocks(m, n, INT8) == blocks


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_int8_plan_fills_one_wave(sms):
    """`_fills_one_wave` at int8's prefill shapes."""
    for k, n in INT8_SHAPES[:5] + INT8_SHAPES[6:7]:
        for m in (17, 63, 126, 255, 510):
            _fills_one_wave(m, k, n, 0, sms, INT8)


@pytest.mark.parametrize("m", [1, 17, 255])
def test_int8_wrappers_take_the_twin_on_the_cpu(m):
    """On CPU tensors `int8_matmul` and its tiled yardstick return the twin
    with every fold at a decode, the least tile-kernel and a prefill M, and
    count no launch, on the wrappers or on the tile kernel's counter."""
    w, x, nw, res = _row_inputs("int8", 512, 600, m, 64, 20 + m)
    fns = (quant.int8_matmul, quant.int8_matmul_tiled)
    before = [fn.launches for fn in fns] + [quant.gemv_tc.launches]
    for kw in (dict(pre_norm=(nw, 1e-5), residual=res, out_dtype=torch.float32),
               {}):
        ref = quant.int8_matmul_plain(x, w.values, w.scale, **kw)
        assert torch.equal(ref, quant.matmul_plain(x, w, **kw))
        for fn in fns:
            assert torch.equal(fn(x, w.values, w.scale, **kw), ref)
    assert [fn.launches for fn in fns] + [quant.gemv_tc.launches] == before
