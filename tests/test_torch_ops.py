"""The port's small ops against the JAX package's, on the same numpy inputs.

f32 comparisons: JAX runs with matmul precision "highest" (conftest), so
both sides compute in full f32 and differ only by summation order:
rtol/atol 1e-5. bf16 comparisons allow one bf16 ulp (rtol 8e-3). Greedy
sampling and the RoPE tables must be EXACT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import GPTConfig as JaxGPTConfig
from uniaudio2_tpu.config import RoPEAdjustments as JaxRoPE
from uniaudio2_tpu.ops import attention as jattn
from uniaudio2_tpu.ops import kv_cache as jkv
from uniaudio2_tpu.ops import norms as jnorms
from uniaudio2_tpu.ops import rope as jrope
from uniaudio2_tpu.ops import sampling as jsampling

from uniaudio2_tpu_torch import config
from uniaudio2_tpu_torch.ops import attention, kv_cache, norms, rope, sampling

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def test_config_registry_equal():
    from uniaudio2_tpu.config import UnifiedModelConfig as JaxUnified
    from uniaudio2_tpu.config import available_configs

    assert config.available_configs() == available_configs()
    for name in available_configs():
        a = config.GPTConfig.from_name(name)
        b = JaxGPTConfig.from_name(name)
        for f in ("n_layer", "n_embd", "n_head", "n_query_groups", "head_size",
                  "intermediate_size", "padded_vocab_size", "rope_base",
                  "norm_eps"):
            assert getattr(a, f) == getattr(b, f), (name, f)
    for mk in ("tiny", None):
        a = config.UnifiedModelConfig.tiny() if mk else config.UnifiedModelConfig()
        b = JaxUnified.tiny() if mk else JaxUnified()
        assert a.tokens.__dict__ == b.tokens.__dict__
        assert a.max_seq_len == b.max_seq_len
        assert a.backbone.n_embd == b.backbone.n_embd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = jnorms.rms_norm(_j(x).astype(jd), _j(w).astype(jd), 1e-5)
    out = norms.rms_norm(_t(x).to(getattr(torch, dtype)),
                         _t(w).to(getattr(torch, dtype)), 1e-5)
    tol = F32 if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("adj", [None, JaxRoPE()])
def test_rope_tables_exact_and_apply(adj):
    padj = None if adj is None else config.RoPEAdjustments()
    jc, js = jrope.rope_cache(300, 64, base=500000.0, adjustments=adj)
    tc, tsn = rope.rope_cache(300, 64, base=500000.0, adjustments=padj,
                               device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tsn.numpy(), np.asarray(js))
    x = np.random.default_rng(1).standard_normal((2, 4, 300, 64)).astype(np.float32)
    np.testing.assert_allclose(rope.apply_rope(_t(x), tc, tsn).numpy(),
                               np.asarray(jrope.apply_rope(_j(x), jc, js)), **F32)


@pytest.mark.parametrize("forbid", [None, 7])
def test_sample_topk_greedy_bit_identical(forbid):
    logits = np.random.default_rng(2).standard_normal((4, 50)).astype(np.float32)
    logits[1, 10] = logits[1, 20] = logits[1].max() + 1.0     # tie: first index
    ref = jsampling.sample_topk(None, _j(logits), 1, 0.9,
                                forbid_prefix=None if forbid is None
                                else jnp.int32(forbid))
    out = sampling.sample_topk(None, _t(logits), 1, 0.9, forbid_prefix=forbid)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_topk_sampled_stays_in_topk():
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 40)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    s = sampling.sample_topk(gen, logits, 3, 1.0, forbid_prefix=5)
    masked = logits.clone()
    masked[:, :5] = -1e30
    top = torch.topk(masked, 3).indices
    assert bool((top == s[:, None]).any(dim=1).all())
    assert int(s.min()) >= 5


def test_mask_prefix_and_cfg_mix():
    x = np.random.default_rng(4).standard_normal((2, 30)).astype(np.float32)
    y = np.random.default_rng(5).standard_normal((2, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        sampling._mask_prefix(_t(x), 11).numpy(),
        np.asarray(jsampling._mask_prefix(_j(x), jnp.int32(11))))
    np.testing.assert_allclose(
        sampling.cfg_mix(_t(x), _t(y), 1.7).numpy(),
        np.asarray(jsampling.cfg_mix(_j(x), _j(y), jnp.float32(1.7))), **F32)


@pytest.mark.parametrize("case", ["plain", "mask2d", "mask3d", "softcap", "window"])
def test_causal_attention(case):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if case == "mask2d":
        m = rng.random((9, 9)) > 0.3
        kw_j["extra_mask"], kw_t["extra_mask"] = _j(m), _t(m)
    if case == "mask3d":
        m = rng.random((2, 9, 9)) > 0.3
        kw_j["extra_mask"], kw_t["extra_mask"] = _j(m), _t(m)
    if case == "softcap":
        kw_j["logit_softcap"] = kw_t["logit_softcap"] = 2.0
    if case == "window":
        kw_j["window"] = kw_t["window"] = 3
    ref = jattn.causal_attention(_j(q), _j(k), _j(v), scale=0.3, **kw_j)
    out = attention.causal_attention(_t(q), _t(k), _t(v), scale=0.3, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("key_valid", [False, True])
def test_decode_attention(key_valid):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    pos = np.array([6], np.int32)
    kv = rng.random((2, 12)) > 0.2 if key_valid else None
    ref = jattn.decode_attention(_j(q), _j(kc), _j(vc), _j(pos),
                                 key_valid=None if kv is None else _j(kv))
    out = attention.decode_attention(_t(q), _t(kc), _t(vc),
                                     _t(pos.astype(np.int64)),
                                     key_valid=None if kv is None else _t(kv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("as_lists", [False, True])
def test_kv_cache_init_and_update(as_lists):
    jcfg = JaxGPTConfig.from_name("tiny-expert")
    tcfg = config.GPTConfig.from_name("tiny-expert")
    jc = jkv.init_cache(jcfg, 2, 10, jnp.float32, as_lists)
    tc = kv_cache.init_cache(tcfg, 2, 10, torch.float32, as_lists,
                             device="cpu")
    assert tc.max_seq == jc.max_seq

    def first(c):       # layer 0: a list item or a view of the stack
        return c[0]

    assert tuple(first(tc.k).shape) == tuple(first(jc.k).shape)
    rng = np.random.default_rng(8)
    kn = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
    vn = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
    jk, jv = jkv.update_layer(first(jc.k), first(jc.v), _j(kn), _j(vn),
                              jnp.int32(4))
    for pos in (4, torch.tensor([4])):
        tc = kv_cache.init_cache(tcfg, 2, 10, torch.float32, as_lists,
                             device="cpu")
        tk, tv = kv_cache.update_layer(first(tc.k), first(tc.v), _t(kn),
                                       _t(vn), pos)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(first(tc.v).numpy(), np.asarray(jv))


def test_int8_kv_cache_not_ported():
    """Once the marker of the unported int8 cache; the cache is ported now
    (held to JAX in `test_torch_kv.py`): ``torch.int8`` builds `QuantKV`
    entries, on the card unless the caller asks for the CPU."""
    cfg = config.GPTConfig.from_name("tiny-expert")
    c = kv_cache.init_cache(cfg, 1, 8, torch.int8, device="cpu")
    assert isinstance(c.k, kv_cache.QuantKV) and c.max_seq == 8
    assert c.k.q.dtype == torch.int8 and c.k.s.dtype == torch.float32
    assert c.k.s.shape == c.k.q.shape[:-1]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            kv_cache.init_cache(cfg, 1, 8, torch.int8)
