"""Every weight format of the port against the JAX package, on the CPU.

Seven containers (int8; K-split, column-packed and row-interleaved int4,
each with per-channel or grouped scales). Containers must be
BYTE-identical. `matmul`, `fused_swiglu` and `qkv_rope_step` run their
plain twins here, which follow the JAX XLA fallback / composed path; in
f32 both sides compute the same products and differ only in the order of
the sums: rtol/atol 1e-5. The four K-split / column-packed Pallas kernels
are also run as the JAX package's own tests run them on the CPU, their
bodies under ``pltpu.force_tpu_interpret_mode()``, against the port's
wrappers: the Pallas body scales after the sum (or dots the group-scaled
tile), another order of the same f32 arithmetic, rtol/atol 1e-4 as in
`tests/test_quant.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.config import GPTConfig as JaxGPTConfig
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.ops import fused_mlp as jfused
from uniaudio2_tpu.ops import qkv_step as jqkv
from uniaudio2_tpu.ops import quant as jq
from uniaudio2_tpu.ops.rope import rope_cache as jrope_cache

from uniaudio2_tpu_torch.config import GPTConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.models import gpt
from uniaudio2_tpu_torch.ops import fused_mlp, qkv_step, quant

F32 = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(rtol=1e-4, atol=1e-4)
FORMS = ("int8", "int4", "int4g", "int4c", "int4cg", "int4i", "int4ig")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.02


def _make(mod, form, w, group=32):
    """``w`` in the container of ``form``, by package ``mod`` (quant / jq)."""
    if form == "int8":
        return mod.quantize(w)
    base = {"int4": "quantize4", "int4i": "quantize4", "int4c": "quantize4_cols",
            "int4g": "quantize4_grouped", "int4ig": "quantize4_grouped",
            "int4cg": "quantize4_cols_grouped"}[form]
    q = getattr(mod, base)(w, group) if "g" in form[4:] else getattr(mod, base)(w)
    return mod.to_interleaved(q) if form in ("int4i", "int4ig") else q


def _pair(form, w, group=32):
    return (_make(jq, form, jnp.asarray(w), group),
            _make(quant, form, torch.from_numpy(w), group))


def _same(tc, jc):
    assert type(tc).__name__ == type(jc).__name__
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))


@pytest.mark.parametrize("group", [128, 32])
@pytest.mark.parametrize("shape", [(256, 300), (3, 256, 130), (512, 1024)])
@pytest.mark.parametrize("fn", ["quantize4_grouped", "quantize4_cols_grouped"])
def test_grouped_quantizers_byte_identical(fn, shape, group):
    w = _w(shape, 1)
    _same(getattr(quant, fn)(torch.from_numpy(w), group),
          getattr(jq, fn)(jnp.asarray(w), group))


@pytest.mark.parametrize("form", ["int4ig", "int4g", "int4cg"])
def test_grouped_relayout_and_dequantizers_equal(form):
    """`to_interleaved` of 4G / C4G is byte-identical, and all three
    grouped dequantizers give JAX's values."""
    w = _w((256, 600), 2)
    for src in (("int4g", "int4cg") if form == "int4ig" else (form,)):
        jw, tw = _pair(src, w)
        if form == "int4ig":
            jw, tw = jq.to_interleaved(jw), quant.to_interleaved(tw)
            assert type(tw) is quant.QuantizedLinearI4G
        _same(tw, jw)
        jd = {"int4g": jq.dequantize4_grouped,
              "int4cg": jq.dequantize4_cols_grouped,
              "int4ig": jq.dequantize4_interleaved_grouped}[form]
        np.testing.assert_array_equal(
            quant.dequantize_any(tw, torch.float32).numpy(),
            np.asarray(jd(jw, jnp.float32)))


@pytest.mark.parametrize("form", ["int4g", "int4ig"])
def test_grouped_chunk_major_round_trip(form):
    """A grouped chunk-major leaf carries ONE more values axis than its
    (G, N) scale; the bridge un-chunks it and the port's `chunk_major`
    reproduces the JAX layout."""
    jw, tw = _pair(form, _w((256, 600), 3))
    jc = jq.chunk_major(jw, 128)
    assert np.asarray(jc.values).ndim == 3 and jq.is_chunk_major(jc)
    tc = quant.chunk_major(tw, 128)
    assert quant.is_chunk_major(tc) and not quant.is_chunk_major(tw)
    _same(tc, jc)
    _same(convert_params(jc, "cpu"), jw)
    with pytest.raises(ValueError, match="row-major 2-D"):
        quant.matmul(torch.zeros(1, 256), tc)


@pytest.mark.parametrize("form", ["int4", "int4g", "int4c", "int4cg"])
def test_stacked_leaves_are_not_chunk_major(form):
    """Layer stacking adds an axis to values and scale alike; slicing a
    stacked grouped leaf keeps each layer's (G, N) scale with its bytes."""
    jw, tw = _pair(form, _w((3, 256, 300), 4))
    assert not quant.is_chunk_major(tw) and not jq.is_chunk_major(jw)
    for i, layer in enumerate(gpt._unbind(tw)):
        one = gpt.index_leaf(tw, i)
        assert type(layer) is type(one) is type(tw)
        _same(one, type(jw)(jw.values[i], jw.scale[i]))
        assert torch.equal(layer.values, one.values)
        assert torch.equal(layer.scale, one.scale)
    assert quant.to_interleaved(tw) is tw             # no-op on stacked


CASES = {"plain": {}, "pre_norm": dict(norm=True), "residual": dict(res=True),
         "out_f32": dict(out_f32=True), "all": dict(norm=True, res=True,
                                                    out_f32=True)}


def _matmul_args(form, dtype, norm=False, res=False, out_f32=False, m=3):
    rng = np.random.default_rng(5)
    k, n = 256, 300
    jw, tw = _pair(form, _w((k, n), 5))
    x = rng.standard_normal((m, k)).astype(np.float32)
    nw = rng.standard_normal(k).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = dict(out_dtype=jnp.float32 if out_f32 else None,
               pre_norm=(jnp.asarray(nw).astype(jd), 1e-5) if norm else None,
               residual=jnp.asarray(r).astype(jd) if res else None)
    tkw = dict(out_dtype=torch.float32 if out_f32 else None,
               pre_norm=(torch.from_numpy(nw).to(td), 1e-5) if norm else None,
               residual=torch.from_numpy(r).to(td) if res else None)
    return (jnp.asarray(x).astype(jd), jw, jkw), \
        (torch.from_numpy(x).to(td), tw, tkw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("form", FORMS)
def test_matmul_every_container_matches_jax(form, case):
    (jx, jw, jkw), (tx, tw, tkw) = _matmul_args(form, "float32", **CASES[case])
    ref = jq.matmul(jx, jw, **jkw)
    out = quant.matmul(tx, tw, **tkw)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("form", FORMS)
def test_matmul_bf16_every_container_matches_jax(form):
    """bf16: both sides round the same f32 sums at the same places, so they
    agree to one bf16 ulp of the output (rtol/atol 1e-2)."""
    (jx, jw, jkw), (tx, tw, tkw) = _matmul_args(form, "bfloat16", norm=True,
                                                res=True)
    ref = jq.matmul(jx, jw, **jkw)
    out = quant.matmul(tx, tw, **tkw)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


PALLAS_FNS = {"int4": ("_pallas_int4_matmul", "int4_matmul"),
              "int4g": ("_pallas_int4g_matmul", "int4g_matmul"),
              "int4c": ("_pallas_int4c_matmul", "int4c_matmul"),
              "int4cg": ("_pallas_int4cg_matmul", "int4cg_matmul")}


@pytest.mark.parametrize("m", [2, 130])
@pytest.mark.parametrize("folds", ["plain", "folded"])
@pytest.mark.parametrize("form", list(PALLAS_FNS))
def test_wrappers_match_pallas_bodies_in_interpret_mode(form, folds, m):
    """The four K-split / column-packed wrappers against the Pallas
    kernels they replace, run in interpret mode (the column-packed kernels
    fold nothing, so their folded case is the f32 output)."""
    cols = form in ("int4c", "int4cg")
    case = {} if folds == "plain" else (
        dict(out_f32=True) if cols else dict(norm=True, res=True, out_f32=True))
    (jx, jw, jkw), (tx, tw, tkw) = _matmul_args(form, "float32", m=m, **case)
    if cols:
        jkw = dict(out_dtype=jkw["out_dtype"])
        tkw = dict(out_dtype=tkw["out_dtype"])
    pallas, wrapper = PALLAS_FNS[form]
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(jq, pallas)(jx, jw.values, jw.scale, **jkw)
    before = getattr(quant, wrapper).launches
    out = getattr(quant, wrapper)(tx, tw.values, tw.scale, **tkw)
    assert getattr(quant, wrapper).launches == before     # the twin: no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PALLAS)


def test_wrappers_refuse_the_other_scale_mode():
    _, k4 = _pair("int4", _w((256, 128)))
    _, k4g = _pair("int4g", _w((256, 128)))
    _, c4 = _pair("int4c", _w((256, 128)))
    _, c4g = _pair("int4cg", _w((256, 128)))
    x = torch.zeros(1, 256)
    for fn, w in ((quant.int4_matmul, k4g), (quant.int4g_matmul, k4),
                  (quant.int4c_matmul, c4g), (quant.int4cg_matmul, c4)):
        with pytest.raises(ValueError, match="scale"):
            fn(x, w.values, w.scale)
    with pytest.raises(ValueError, match="scale groups"):
        quant.int4g_matmul(x, k4g.values, k4g.scale[:3].contiguous())


FIELDS = dict(name="formats-test", block_size=64, vocab_size=512,
              padded_vocab_size=512, n_layer=1, n_embd=256, n_head=4,
              n_query_groups=2, intermediate_size=512, rope_base=10000.0,
              rope_adjustments=None)
SWIGLU_FORMS = [(a, b) for a in ("int8", "int4", "int4g")
                for b in ("int8", "int4c", "int4cg")] \
    + [(a, b) for a in ("int4i", "int4ig") for b in ("int8", "int4i", "int4ig")]


def _layer(up, down, qkv):
    """One layer's weights in the given forms, as (JAX dict, port dict)."""
    rng = np.random.default_rng(6)
    shapes = {"qkv_w": (256, 512), "attn_proj_w": (256, 256),
              "fc1_w": (256, 512), "fc2_w": (256, 512), "mlp_proj_w": (512, 256)}
    forms = {"qkv_w": qkv, "attn_proj_w": qkv, "fc1_w": up, "fc2_w": up,
             "mlp_proj_w": down}
    jl, tl = {}, {}
    for name, shape in shapes.items():
        jl[name], tl[name] = _pair(forms[name], _w(shape, len(name)))
    for name in ("norm1_w", "norm2_w"):
        g = (1.0 + 0.3 * rng.standard_normal(256)).astype(np.float32)
        jl[name], tl[name] = jnp.asarray(g), torch.from_numpy(g)
    return jl, tl


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("up,down", SWIGLU_FORMS)
def test_fused_swiglu_twin_matches_jax_mlp(up, down, folded):
    """Every admitted gate / up + down combination: the port dispatches to
    `fused_swiglu` (its twin here), JAX on the CPU to its composed path."""
    jl, tl = _layer(up, down, "int8")
    x = np.random.default_rng(7).standard_normal((2, 3, 256)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert fused_mlp.can_fuse(tl["fc1_w"], tl["fc2_w"], tl["mlp_proj_w"], tx)
    jcfg, tcfg = JaxGPTConfig(**FIELDS), GPTConfig(**FIELDS)
    if folded:
        ref, out = jgpt._mlp_block(jl, jx, jcfg), gpt._mlp_block(tl, tx, tcfg)
    else:
        ref, out = jgpt._mlp(jl, jx, jcfg), gpt._mlp(tl, tx, tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("up,down", [("int4", "int4c"), ("int4g", "int4cg"),
                                     ("int8", "int8"), ("int4ig", "int4ig")])
def test_fused_swiglu_twin_matches_pallas_body(up, down):
    """The twin against the fused Pallas kernel itself in interpret mode,
    with the norm and the residual folded."""
    jl, tl = _layer(up, down, "int8")
    x = np.random.default_rng(8).standard_normal((2, 256)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jfused.fused_swiglu(
            jnp.asarray(x), jl["fc1_w"], jl["fc2_w"], jl["mlp_proj_w"],
            norm_w=jl["norm2_w"], norm_eps=1e-5, residual=jnp.asarray(x))
    out = fused_mlp.fused_swiglu(
        torch.from_numpy(x), tl["fc1_w"], tl["fc2_w"], tl["mlp_proj_w"],
        norm_w=tl["norm2_w"], norm_eps=1e-5, residual=torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PALLAS)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("mode", ["int8", "int4", "int4g", "int4i", "int4ig"])
def test_qkv_rope_step_twin_matches_jax_qkv(mode, b):
    jl, tl = _layer("int8", "int8", mode)
    x = np.random.default_rng(9).standard_normal((b, 1, 256)).astype(np.float32)
    cos, sin = jrope_cache(16, 64, base=10000.0)
    tx = torch.from_numpy(x)
    assert qkv_step.can_fuse(tl["qkv_w"], tx[:, 0], 4, 2, 64)
    ref = jgpt._qkv(jl, JaxGPTConfig(**FIELDS), jnp.asarray(x), cos[5:6],
                    sin[5:6], pre_norm=(jl["norm1_w"], 1e-5))
    out = gpt._qkv(tl, GPTConfig(**FIELDS), tx,
                   torch.from_numpy(np.array(cos[5:6])),
                   torch.from_numpy(np.array(sin[5:6])),
                   pre_norm=(tl["norm1_w"], 1e-5))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32)


@pytest.mark.parametrize("mode", ["int4", "int4g"])
def test_qkv_rope_step_twin_matches_pallas_body(mode):
    jl, tl = _layer("int8", "int8", mode)
    x = np.random.default_rng(10).standard_normal((2, 256)).astype(np.float32)
    cos, sin = jrope_cache(16, 64, base=10000.0)
    # 128-wide chunks: the Pallas grid needs whole streams per chunk
    jw = jq.chunk_major(jl["qkv_w"], 128)
    assert jqkv.can_fuse(jw, jnp.asarray(x), 4, 2, 64)
    with pltpu.force_tpu_interpret_mode():
        ref = jqkv.qkv_rope_step(jnp.asarray(x), jw, jl["norm1_w"],
                                 1e-5, cos[5], sin[5], 4, 2, 64)
    out = qkv_step.qkv_rope_step(
        torch.from_numpy(x), tl["qkv_w"], tl["norm1_w"], 1e-5,
        torch.from_numpy(np.array(cos[5])), torch.from_numpy(np.array(sin[5])),
        4, 2, 64)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **PALLAS)


# (gate / up form, down form, rows, K, I, N, gate group, down group)
MLP_GATE_CASES = [
    ("int8", "int8", 2, 256, 512, 256, 32, 32),
    ("int8", "int4c", 2, 256, 512, 256, 32, 32),
    ("int8", "int4i", 2, 256, 512, 256, 32, 32),       # wrong family
    ("int4", "int4cg", 128, 256, 512, 256, 32, 32),
    ("int4", "int4", 2, 256, 512, 256, 32, 32),        # K-split down
    ("int4g", "int4cg", 2, 256, 512, 256, 128, 128),
    ("int4g", "int4cg", 2, 256, 512, 256, 32, 256),    # 128 % down group
    ("int4g", "int4c", 129, 256, 512, 256, 32, 32),    # too many rows
    ("int4i", "int4ig", 2, 256, 512, 256, 32, 64),
    ("int4i", "int4c", 2, 256, 512, 256, 32, 32),      # wrong family
    ("int4ig", "int8", 2, 256, 512, 256, 64, 32),
    ("int4ig", "int4i", 2, 128, 512, 256, 32, 32),     # K % 256
    ("int4ig", "int4ig", 2, 256, 640, 256, 32, 32),    # I % 256
    ("int4", "int4c", 2, 256, 300, 256, 32, 32),       # lane-padded I
    ("int4c", "int4c", 2, 256, 512, 256, 32, 32),      # column-packed gate
]


@pytest.mark.parametrize("case", MLP_GATE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_mlp_can_fuse_matches_jax(case):
    up, down, rows, k, i, n, g12, g3 = case
    j1, t1 = _pair(up, _w((k, i), 1), g12)
    j3, t3 = _pair(down, _w((i, n), 2), g3)
    want = jfused.can_fuse(j1, j1, j3, jnp.zeros((rows, k)))
    assert fused_mlp.can_fuse(t1, t1, t3, torch.zeros(rows, k)) == want
    j2, t2 = _pair("int8" if up != "int8" else "int4", _w((k, i), 3))
    assert not fused_mlp.can_fuse(t1, t2, t3, torch.zeros(rows, k))
    assert not jfused.can_fuse(j1, j2, j3, jnp.zeros((rows, k)))


# (form, rows, K, heads, kv groups, head size, scale group)
QKV_GATE_CASES = [
    ("int8", 2, 256, 4, 2, 64, 32), ("int4", 128, 256, 4, 2, 64, 32),
    ("int4g", 1, 256, 4, 2, 64, 128), ("int4i", 129, 256, 4, 2, 64, 32),
    ("int4ig", 2, 256, 4, 2, 64, 64), ("int4c", 2, 256, 4, 2, 64, 32),
    ("int4cg", 2, 256, 4, 2, 64, 32), ("int4", 2, 128, 4, 2, 64, 32),
    ("int8", 2, 256, 2, 1, 128, 32), ("int4g", 2, 256, 3, 1, 128, 32),
]


@pytest.mark.parametrize("case", QKV_GATE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_qkv_can_fuse_matches_jax(case):
    """The port's gate is JAX's without the chunk rules (a block of the
    CUDA kernel owns one head): JAX is asked about the same weight in
    128-wide chunks, where those rules pass."""
    form, rows, k, h, g, hd, group = case
    jw, tw = _pair(form, _w((k, 512), 4), group)
    assert qkv_step.can_fuse(tw, torch.zeros(rows, k), h, g, hd) == \
        jqkv.can_fuse(jq.chunk_major(jw, 128), jnp.zeros((rows, k)), h, g, hd)


@pytest.mark.parametrize("form", FORMS)
def test_no_container_raises_not_implemented(form):
    """Every container type is admitted or refused by a value, never by
    NotImplementedError, in `matmul` and in both `can_fuse` gates."""
    _, tw = _pair(form, _w((256, 512), 5))
    x = torch.zeros(2, 256)
    assert quant.matmul(x, tw).shape == (2, 512)
    assert isinstance(fused_mlp.can_fuse(tw, tw, tw, x), bool)
    assert isinstance(qkv_step.can_fuse(tw, x, 4, 2, 64), bool)
    assert quant.kernel_eligible(tw, 256)
    assert not quant.kernel_eligible(tw, 64)


def test_q_keeps_groups_only_where_they_divide_k():
    """"4g" falls back to per-channel int4 when K is not a multiple of 256
    (128 for the column-packed leaf), as in the JAX package."""
    for k, cols, want in ((256, False, "QuantizedLinear4G"),
                          (128, False, "QuantizedLinear4"),
                          (128, True, "QuantizedLinearC4G"),
                          (64, True, "QuantizedLinearC4")):
        w = _w((k, 128), 6)
        tw = quant._q(torch.from_numpy(w), "4g", cols)
        jw = jq._q(jnp.asarray(w), False, "4g", cols)
        assert type(tw).__name__ == want
        _same(tw, jw)
