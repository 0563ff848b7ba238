"""The port's quantized containers and `matmul` against the JAX package.

Containers must be BYTE-identical (same rounding, packing and padding).
`matmul` on CPU runs the plain twins, which follow the JAX XLA fallback:
f32 cases agree to summation order (rtol/atol 1e-5); bf16 cases to one
bf16 ulp of the output (rtol/atol 1e-2 — both round the same f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch.convert.from_jax import convert_params, to_tensor
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops import quant

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.02


def _same(tc, jc):
    assert type(tc).__name__ == type(jc).__name__
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))


@pytest.mark.parametrize("shape", [(64, 300), (256, 600), (3, 64, 130)])
@pytest.mark.parametrize("fn", ["quantize", "quantize4", "quantize4_cols"])
def test_quantizers_byte_identical(shape, fn):
    w = _w(shape)
    _same(getattr(quant, fn)(torch.from_numpy(w)), getattr(jq, fn)(jnp.asarray(w)))


@pytest.mark.parametrize("fn", ["quantize4", "quantize4_cols"])
def test_to_interleaved_byte_identical(fn):
    w = _w((128, 600), 1)
    t = quant.to_interleaved(getattr(quant, fn)(torch.from_numpy(w)))
    j = jq.to_interleaved(getattr(jq, fn)(jnp.asarray(w)))
    _same(t, j)
    np.testing.assert_allclose(quant.dequantize4_interleaved(t, torch.float32).numpy(),
                               np.asarray(jq.dequantize4_interleaved(j, jnp.float32)),
                               **F32)


def test_dequantizers_equal():
    w = _w((128, 600), 2)
    for fn, dq in (("quantize", "dequantize"), ("quantize4", "dequantize4"),
                   ("quantize4_cols", "dequantize4_cols")):
        t = getattr(quant, dq)(getattr(quant, fn)(torch.from_numpy(w)),
                               torch.float32)
        j = getattr(jq, dq)(getattr(jq, fn)(jnp.asarray(w)), jnp.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fn", ["quantize", "quantize4"])
def test_chunk_major_round_trip(fn):
    """A JAX chunk_major(w, 128) leaf un-chunks to the row-major bytes, and
    the port's chunk_major reproduces the JAX layout."""
    w = _w((128, 600), 3)
    jw = getattr(jq, fn)(jnp.asarray(w))
    if fn == "quantize4":
        jw = jq.to_interleaved(jw)
    jc = jq.chunk_major(jw, 128)
    assert jq.is_chunk_major(jc) and np.asarray(jc.values).ndim == 3
    tc = convert_params(jc, "cpu")
    _same(tc, jw)
    _same(quant.chunk_major(convert_params(jw, "cpu"), 128), jc)


@pytest.mark.parametrize("fn", ["quantize", "quantize4"])
def test_matmul_refuses_chunk_major(fn):
    """Only the bridge un-chunks: a chunk-major leaf reaching matmul raises
    rather than being re-laid out on every call."""
    w = torch.from_numpy(_w((128, 600), 3))
    q = getattr(quant, fn)(w)
    if fn == "quantize4":
        q = quant.to_interleaved(q)
    with pytest.raises(ValueError, match="row-major 2-D"):
        quant.matmul(torch.zeros(1, 128), quant.chunk_major(q, 128))


def _matmul_case(kind, m, dtype, norm, res, out_f32, seed=4):
    rng = np.random.default_rng(seed)
    k, n = 256, 300
    w = _w((k, n), seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    nw = rng.standard_normal(k).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "int8":
        jw, tw = jq.quantize(jnp.asarray(w)), quant.quantize(torch.from_numpy(w))
    else:
        jw = jq.to_interleaved(jq.quantize4(jnp.asarray(w)))
        tw = quant.to_interleaved(quant.quantize4(torch.from_numpy(w)))
    jkw = dict(out_dtype=jnp.float32 if out_f32 else None,
               pre_norm=(jnp.asarray(nw).astype(jd), 1e-5) if norm else None,
               residual=jnp.asarray(r).astype(jd) if res else None)
    tkw = dict(out_dtype=torch.float32 if out_f32 else None,
               pre_norm=(torch.from_numpy(nw).to(td), 1e-5) if norm else None,
               residual=torch.from_numpy(r).to(td) if res else None)
    ref = jq.matmul(jnp.asarray(x).astype(jd), jw, **jkw)
    out = quant.matmul(torch.from_numpy(x).to(td), tw, **tkw)
    return out, ref


@pytest.mark.parametrize("kind", ["int8", "int4i"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm,res,out_f32", [(False, False, False),
                                              (True, True, False),
                                              (True, False, True)])
def test_matmul_matches_jax(kind, dtype, norm, res, out_f32):
    out, ref = _matmul_case(kind, 3, dtype, norm, res, out_f32)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **(F32 if dtype == "float32" else BF16))


def test_matmul_plain_and_kspilt_weights():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    w = _w((128, 200), 5)
    np.testing.assert_allclose(
        quant.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jq.matmul(jnp.asarray(x), jnp.asarray(w))), **F32)
    for fn in ("quantize4", "quantize4_cols"):
        np.testing.assert_allclose(
            quant.matmul(torch.from_numpy(x),
                         getattr(quant, fn)(torch.from_numpy(w))).numpy(),
            np.asarray(jq.matmul(jnp.asarray(x), getattr(jq, fn)(jnp.asarray(w)))),
            **F32)


def test_cpu_wrappers_take_the_twin_without_counting():
    before = (quant.int4i_matmul.launches, quant.int8_matmul.launches)
    _matmul_case("int4i", 2, "float32", True, True, False)
    _matmul_case("int8", 2, "float32", True, True, False)
    assert (quant.int4i_matmul.launches, quant.int8_matmul.launches) == before


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_unified_serving_params_byte_identical():
    """quantize_unified_params (int4all) + prepare_serving_params in the port
    give the JAX package's containers (JAX's chunk-major leaves un-chunked
    by the bridge)."""
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(0), jcfg)
    int4 = ("backbone", "decoder", "understanding_expert", "generation_expert",
            "audio_head", "projection_w")
    tp = convert_params(jp, "cpu")
    tserve = unified.prepare_serving_params(
        quant.quantize_unified_params(tp, int4_modules=int4), dtype=torch.float32)
    jserve = convert_params(junified.prepare_serving_params(
        jq.quantize_unified_params(jp, int4_modules=int4), dtype=jnp.float32,
        cfg=jcfg), "cpu")
    tl, jl = dict(_leaves(tserve)), dict(_leaves(jserve))
    assert tl.keys() == jl.keys()
    for path, t in tl.items():
        j = jl[path]
        if path == "/audio_embeddings_proj":
            np.testing.assert_allclose(t.numpy(), j.numpy(), **F32)
        elif isinstance(t, tuple):
            assert type(t) is type(j), path
            np.testing.assert_array_equal(t.values.numpy(), j.values.numpy())
            np.testing.assert_array_equal(t.scale.numpy(), j.scale.numpy())
        else:
            np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_grouped_not_ported():
    """No grouped format is left unported: the grouped tree quantizes, a
    grouped container crosses the bridge with its bytes, and `matmul`
    takes it."""
    tp = convert_params(junified.init_params(jax.random.PRNGKey(0),
                                             JaxConfig.tiny()), "cpu")
    quant.quantize_unified_params(tp, int4_modules=("decoder",), grouped=True)
    jw = jq.quantize4_grouped(jnp.asarray(_w((256, 128))))
    tw = convert_params(jw, "cpu")
    _same(tw, jw)
    x = _w((2, 256), 1)
    np.testing.assert_allclose(
        quant.matmul(torch.from_numpy(x), tw).numpy(),
        np.asarray(jq.matmul(jnp.asarray(x), jw)), **F32)


def test_bf16_bridge_exact():
    x = jnp.asarray(_w((4, 8))).astype(jnp.bfloat16)
    t = to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
