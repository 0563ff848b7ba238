"""The port's int8 KV cache, prefix-bounded reads and deferred writes against
the JAX functions (`uniaudio2_tpu/ops/kv_cache.py`, `ops/attention.py`):
the function-level cases of `tests/test_kv_quant.py` and
`tests/test_kv_write_deferred.py`, each fed the same numpy inputs on both
sides.

Tolerances: `QuantKV` bytes and scales must be identical (the same f32
division and half-to-even rounding). `decode_attention` must agree within
1e-5 x max|jax| in f32: the int8 path's integer sums are exact on both sides
(int32 in JAX, float32 sums of integers below 2^24 in the port), so only the
float32 softmax and scale products differ in their last bits. With a bf16
cache the probabilities are rounded to bf16 before P.V on both sides, so the
two may differ by one bf16 rounding of the output: 2^-8 x max|jax|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import GPTConfig as JaxGPTConfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.ops import attention as jatt
from uniaudio2_tpu.ops import kv_cache as jkv

from uniaudio2_tpu_torch.config import GPTConfig
from uniaudio2_tpu_torch.engine import decode
from uniaudio2_tpu_torch.ops import attention, kv_cache

GEOM = dict(name="t", n_layer=3, n_embd=64, n_head=4, n_query_groups=2,
            intermediate_size=128, padded_vocab_size=64, vocab_size=64)
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _representable(rng, shape, scale=2.0 ** -6):
    """Integers in [-126, 126] times a power of two, one slot pinned to
    127: lossless under absmax int8 (the JAX tests' inputs)."""
    ints = rng.integers(-126, 127, shape)
    ints[..., 0] = 127
    return (ints * scale).astype(np.float32)


def _inputs(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "representable":
        return _representable(rng, shape)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "zero_slot":
        x[..., 1, :] = 0.0
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(x):
    if isinstance(x, (kv_cache.QuantKV, jkv.QuantKV)):
        return type(x)(_np(x.q), _np(x.s))
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_entry(port, ref):
    """A port cache entry equal to JAX's: int8 bytes and scales, or values."""
    if isinstance(ref, jkv.QuantKV):
        assert isinstance(port, kv_cache.QuantKV)
        np.testing.assert_array_equal(port.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(port.s.numpy(), np.asarray(ref.s))
    else:
        np.testing.assert_array_equal(_np(port), np.asarray(ref, np.float32))


@pytest.mark.parametrize("kind", ["representable", "normal", "zero_slot"])
def test_quantize_slots_bytes_identical(kind):
    x = _inputs(kind, (2, 3, 5, 16))
    ref, out = jkv.quantize_slots(jnp.asarray(x)), kv_cache.quantize_slots(_t(x))
    assert out.q.dtype == torch.int8 and out.s.dtype == torch.float32
    _same_entry(out, ref)
    if kind == "representable":     # lossless, as the JAX test checks
        np.testing.assert_allclose(
            (out.q.float() * out.s[..., None]).numpy(), x, rtol=1e-6)


def test_init_cache_int8_shapes_and_views():
    cfg = GPTConfig(**GEOM)
    c = kv_cache.init_cache(cfg, 2, 32, dtype=torch.int8, device="cpu")
    assert isinstance(c.k, kv_cache.QuantKV) and c.max_seq == 32
    assert c.k.q.shape == (3, 2, 2, 32, 16) and c.k.q.dtype == torch.int8
    assert c.k.s.shape == (3, 2, 2, 32) and c.k.s.dtype == torch.float32
    lists = kv_cache.init_cache(cfg, 2, 32, dtype=torch.int8, as_lists=True,
                                device="cpu")
    assert isinstance(lists.k, list) and isinstance(lists.k[0], kv_cache.QuantKV)
    assert lists.max_seq == 32 and lists.k[0].q.shape == (2, 2, 32, 16)
    un = kv_cache.unstack_cache(c)
    assert isinstance(un.k[1], kv_cache.QuantKV) and un.k[1].q.shape == (2, 2, 32, 16)
    # per-layer entries are views: a write through one lands in the stack
    k_new = torch.from_numpy(_inputs("normal", (2, 2, 1, 16)))
    kv_cache.update_layer(un.k[1], un.v[1], k_new, k_new, 4)
    np.testing.assert_array_equal(c.k.q[1, :, :, 4].numpy(),
                                  kv_cache.quantize_slots(k_new).q[:, :, 0].numpy())
    entry = kv_cache.layer_entry(c.k, 2)
    assert kv_cache.set_layer_entry(c.k, 2, entry) is c.k


@pytest.mark.parametrize("as_lists", [False, True])
@pytest.mark.parametrize("device_pos", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_update_layer_matches_jax(dtype, device_pos, as_lists):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[dtype]
    jcfg, tcfg = JaxGPTConfig(**GEOM), GPTConfig(**GEOM)
    jc = jkv.init_cache(jcfg, 1, 8, dtype=jdt, as_lists=as_lists)
    tc = kv_cache.init_cache(tcfg, 1, 8, dtype=tdt, as_lists=as_lists,
                             device="cpu")
    k_new = _inputs("normal", (1, 2, 2, 16), seed=1)
    v_new = _inputs("normal", (1, 2, 2, 16), seed=2)
    pos = torch.tensor([3]) if device_pos else 3
    if as_lists:
        jk, jv = jc.k[0], jc.v[0]
        tk, tv = tc.k[0], tc.v[0]
    else:
        jk, jv = jkv.layer_entry(jc.k, 0), jkv.layer_entry(jc.v, 0)
        tk, tv = kv_cache.layer_entry(tc.k, 0), kv_cache.layer_entry(tc.v, 0)
    jk, jv = jkv.update_layer(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.int32(3))
    kv_cache.update_layer(tk, tv, _t(k_new), _t(v_new), pos)
    _same_entry(tk, jk)
    _same_entry(tv, jv)
    if not as_lists:        # the write went into the stacked buffer itself
        _same_entry(kv_cache.layer_entry(tc.k, 0), jk)


@pytest.mark.parametrize("device_pos", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_update_stacked_matches_jax_and_per_layer(dtype, device_pos):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[dtype]
    jcfg, tcfg = JaxGPTConfig(**GEOM), GPTConfig(**GEOM)
    jc = jkv.init_cache(jcfg, 2, 16, dtype=jdt)
    tc = kv_cache.init_cache(tcfg, 2, 16, dtype=tdt, device="cpu")
    ref = kv_cache.init_cache(tcfg, 2, 16, dtype=tdt, as_lists=True,
                              device="cpu")
    k_new = _inputs("normal", (3, 2, 2, 1, 16), seed=3)
    v_new = _inputs("normal", (3, 2, 2, 1, 16), seed=4)
    pos = torch.tensor([5]) if device_pos else 5
    jk, jv = jkv.update_stacked(jc.k, jc.v, jnp.asarray(k_new),
                                jnp.asarray(v_new), jnp.int32(5))
    tk, tv = kv_cache.update_stacked(tc.k, tc.v, _t(k_new), _t(v_new), pos)
    assert tk is tc.k and tv is tc.v            # in place
    _same_entry(tk, jk)
    _same_entry(tv, jv)
    for i in range(3):      # one coalesced write == the per-layer writes
        kv_cache.update_layer(ref.k[i], ref.v[i], _t(k_new[i]), _t(v_new[i]),
                              pos)
        _same_entry(kv_cache.layer_entry(tc.k, i),
                    jkv.layer_entry(jk, i))
        a, b = kv_cache.layer_entry(tc.v, i), ref.v[i]
        if isinstance(a, kv_cache.QuantKV):
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
        else:
            assert torch.equal(a, b)


def _cache_case(cache, kind, b=2, g=2, s=16, hd=16, pos=9, fresh=False):
    """Cache contents (numpy f32, zero past the filled prefix when the
    fresh K/V are the current token's) and the cache entries of each side
    (JAX array / QuantKV, port tensor / QuantKV)."""
    k = _inputs(kind, (b, g, s, hd), seed=11)
    v = _inputs(kind, (b, g, s, hd), seed=12)
    if fresh:
        keep = (np.arange(s) < pos)[None, None, :, None]
        k, v = k * keep, v * keep
    if cache == "int8":
        jk, jv = jkv.quantize_slots(jnp.asarray(k)), jkv.quantize_slots(jnp.asarray(v))
        return (jk, jv), (kv_cache.quantize_slots(_t(k)), kv_cache.quantize_slots(_t(v)))
    if cache == "bf16":
        return ((jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)),
                (_t(k).bfloat16(), _t(v).bfloat16()))
    return (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))


OPTIONS = {
    "plain": {},
    "key_valid+window": dict(window=6),
    "softcap": dict(logit_softcap=30.0),
}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("levels", [None, (8, 16)])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_attention_matches_jax(cache, levels, fresh, option):
    b, g, p, t, s, hd, pos = 2, 2, 2, 1, 16, 16, 9
    kind = "representable" if option == "plain" and cache == "int8" else "normal"
    (jk, jv), (tk, tv) = _cache_case(cache, kind, b, g, s, hd, pos, fresh)
    q = _inputs(kind, (b, g * p, t, hd), seed=13)
    kw = dict(OPTIONS[option])
    jkw, tkw = dict(kw), dict(kw)
    if option == "key_valid+window":
        valid = np.random.default_rng(0).random((b, s)) > 0.3
        valid[:, pos] = True
        jkw["key_valid"], tkw["key_valid"] = jnp.asarray(valid), _t(valid)
        jkw["window"] = jnp.int32(6)
    if fresh:
        kf = _inputs("normal", (b, g, t, hd), seed=14)
        vf = _inputs("normal", (b, g, t, hd), seed=15)
        jkw["fresh_kv"] = (jnp.asarray(kf), jnp.asarray(vf))
        tkw["fresh_kv"] = (_t(kf), _t(vf))
    ref = jatt.decode_attention(jnp.asarray(q), jk, jv,
                                jnp.asarray([pos], jnp.int32),
                                prefix_levels=levels, **jkw)
    if levels is not None:
        tkw["filled"] = pos + (0 if fresh else 1)
    out = attention.decode_attention(_t(q), tk, tv, torch.tensor([pos]),
                                     prefix_levels=levels, **tkw)
    assert tuple(out.shape) == ref.shape
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    ref = np.asarray(ref, np.float32)
    out = out.float()
    tol = BF16_TOL if cache == "bf16" else F32_TOL
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("pos", [5, 8, 20, 31])
def test_prefix_levels_read_equals_full_read(pos, cache, fresh):
    """Bounded reads give the full read's result in the port itself, at
    every level and on each side of a boundary (the masked tail adds exact
    zeros; the int8 path's sums are exact either way)."""
    (_, _), (tk, tv) = _cache_case(cache, "normal", s=32, pos=pos, fresh=fresh)
    q = torch.from_numpy(_inputs("normal", (2, 4, 1, 16), seed=21))
    kw = {}
    if fresh:
        kw["fresh_kv"] = (torch.from_numpy(_inputs("normal", (2, 2, 1, 16), 22)),
                          torch.from_numpy(_inputs("normal", (2, 2, 1, 16), 23)))
    qpos = torch.tensor([pos])
    full = attention.decode_attention(q, tk, tv, qpos, **kw)
    levels = (8, 16, 24, 32)
    bounded = attention.decode_attention(q, tk, tv, qpos, prefix_levels=levels,
                                         filled=pos + (0 if fresh else 1), **kw)
    if cache == "int8":
        assert torch.equal(bounded, full)
    else:
        np.testing.assert_allclose(bounded.numpy(), full.numpy(), rtol=0,
                                   atol=1e-6 * full.abs().max().item())


def test_pick_level_matches_searchsorted_and_switch():
    levels = (128, 256, 384, 512, 640, 768)
    for need in (1, 127, 128, 129, 256, 257, 700, 768, 769, 2000):
        sel = int(np.searchsorted(np.asarray(levels), need, side="left"))
        assert attention.pick_level(levels, need) == levels[min(sel, 5)]


def test_device_positions_are_never_read():
    """Without the host's slot count a multi-level read is refused: the
    position, wherever it lies, is never read back."""
    (_, _), (tk, tv) = _cache_case("f32", "normal", s=32)
    q = torch.from_numpy(_inputs("normal", (2, 4, 1, 16), seed=21))
    for where in ("meta", "cpu"):
        with pytest.raises(ValueError, match="filled"):
            attention.decode_attention(q, tk, tv,
                                       torch.tensor([5], device=where),
                                       prefix_levels=(16, 32))


def test_quant_cache_tracks_f32_with_fresh_column():
    """The JAX package's accuracy contract of the int8 read, on the port:
    representable values agree within 2 % of the range; random ones within
    5 % relative error (test_kv_quant.py, test_kv_write_deferred.py)."""
    (_, _), (k8, v8) = _cache_case("int8", "representable")
    (_, _), (kf, vf) = _cache_case("f32", "representable")
    q = torch.from_numpy(_inputs("representable", (2, 4, 1, 16), seed=13))
    exact = attention.decode_attention(q, kf, vf, torch.tensor([9]))
    quant = attention.decode_attention(q, k8, v8, torch.tensor([9]))
    assert (quant - exact).abs().max() <= 0.02 * exact.abs().max()
    (_, _), (k8, v8) = _cache_case("int8", "normal", pos=9, fresh=True)
    (_, _), (kf, vf) = _cache_case("f32", "normal", pos=9, fresh=True)
    fr = (torch.from_numpy(_inputs("normal", (2, 2, 1, 16), 14)),
          torch.from_numpy(_inputs("normal", (2, 2, 1, 16), 15)))
    q = torch.from_numpy(_inputs("normal", (2, 4, 1, 16), seed=13))
    exact = attention.decode_attention(q, kf, vf, torch.tensor([9]), fresh_kv=fr)
    quant = attention.decode_attention(q, k8, v8, torch.tensor([9]), fresh_kv=fr)
    assert ((quant - exact).norm() / exact.norm()).item() < 0.05


def test_int8_value_sums_exact_past_two_to_the_24():
    """P.V over more than 1040 slots passes 2^24; the chunked float32 sums
    must still give JAX's int32 sum, converted to float32 once."""
    rng = np.random.default_rng(5)
    p = np.full((1, 1, 1, 1, 1536), 127, np.int8)
    v = rng.integers(100, 128, (1, 1, 1536, 16)).astype(np.int8)
    ref = np.einsum("bgpts,bgsh->bgpth", p.astype(np.int64), v.astype(np.int64))
    assert ref.max() > 2 ** 24
    out = attention._int_values(torch.from_numpy(p), torch.from_numpy(v))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int32).astype(np.float32))


KNOBS = {
    "UA2_KV_QUANT": ("1", "off", "int8", "auto", "bogus"),
    "UA2_KV_WRITE": ("deferred", "INLINE", "maybe"),
    "UA2_ATTN_BLOCK": ("auto", "0", "64"),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_env_knobs_pick_the_jax_policy(monkeypatch, knob):
    """The three serving knobs are the JAX engine's interface: each value
    resolves to the same policy on both sides (or raises on both)."""
    for value in KNOBS[knob]:
        monkeypatch.setenv(knob, value)
        if knob == "UA2_KV_QUANT":
            for cache_len, batch in ((64, 1), (256, 8), (768, 1)):
                try:
                    j = jdecode.resolve_kv_quant(None, cache_len, jnp.bfloat16,
                                                 batch=batch) == jnp.int8
                except ValueError:
                    with pytest.raises(ValueError):
                        decode.resolve_kv_quant(None, cache_len, torch.bfloat16,
                                                batch=batch)
                    continue
                t = decode.resolve_kv_quant(None, cache_len, torch.bfloat16,
                                            batch=batch) == torch.int8
                assert t == j
        elif knob == "UA2_KV_WRITE":
            try:
                j = jdecode.resolve_kv_write(None)
            except ValueError:
                with pytest.raises(ValueError):
                    decode.resolve_kv_write(None)
                continue
            assert decode.resolve_kv_write(None) == j
        else:
            eng = decode.DecodeEngine({"audio_embeddings": torch.zeros(1)},
                                      _tiny_cfg())
            expect = -1 if value == "auto" else int(value)
            assert eng.attn_block == expect
            for cache_len in (256, 512, 768):
                assert decode.resolve_attn_block(eng.attn_block, cache_len) == \
                    jdecode.resolve_attn_block(expect, cache_len)


def _tiny_cfg():
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    return UnifiedModelConfig.tiny()


def test_deferred_write_needs_the_stacked_cache():
    from uniaudio2_tpu_torch.models import gpt

    cfg = GPTConfig(**GEOM)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    x = torch.zeros((1, 1, 64))
    lists = kv_cache.init_cache(cfg, 1, 8, torch.float32, as_lists=True,
                                device="cpu")
    with pytest.raises(ValueError, match="STACKED"):
        gpt.decode_step(params, cfg, x, lists, 2, kv_write="deferred")
    stacked = kv_cache.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="T == 1"):
        gpt.decode_step(params, cfg, torch.zeros((1, 2, 64)), stacked, 2,
                        kv_write="deferred")
