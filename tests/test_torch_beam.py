"""The port's host-driven decoding against the JAX `DecodeEngine` on
`tiny()`: beam search, n-gram-blocked text decoding and the cache reorder
that beam search runs between steps.

* `kv_cache.reorder` gathers the batch rows of every cache tensor in
  place; it must give JAX's ``reorder_fn`` (the one `_get_host_step`
  compiles) bit for bit, on bf16 and int8 `QuantKV` caches, per-layer
  lists and stacked.
* Beam 1 is greedy decoding; beam 3 gives JAX's beam 3 (and not the
  greedy tokens, on this model); beam 2 for 3 steps
  runs on the int8 cache (`tests/test_kv_quant.py::test_beam_reorder_int8`).
* ``generate_text(no_repeat_ngram=n)`` samples on the host with
  ``np.random.default_rng(seed)`` as JAX does, so its tokens equal JAX's
  greedy (topk=1) and sampled (topk=5, one seed) wherever the two
  packages' logits agree; no step here lies near a tie (the comparison
  would fail at it, and a tie would have to be certified on JAX's logits
  as `tests/test_torch_kv_engine.py` does).

f32 caches (conftest sets JAX's matmul precision to "highest"); the JAX
programs compiled here: one reorder per cache form, and a prefill and a
step for each (bucket, beam width, cache) pair, six in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import decode
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops.kv_cache import QuantKV, reorder

FRAMES = 12
REPEATING = [5, 6, 7, 300]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    """A tiny model whose lm_head keeps the columns of four tokens (x20)
    and zeroes the rest: its greedy text repeats a 3-gram from the first
    frames, so blocking changes the tokens and the beams differ."""
    jcfg = JaxConfig.tiny()
    params = junified.init_params(jax.random.PRNGKey(1), jcfg)
    w = params["backbone"]["lm_head_w"]
    keep = jnp.zeros((w.shape[-1],), bool).at[jnp.array(REPEATING)].set(True)
    params = dict(params, backbone=dict(
        params["backbone"], lm_head_w=jnp.where(keep, w, 0.0) * 20))
    rng = np.random.default_rng(2)
    asr = jtasks.prepare_asr(np.array([4, 8, 9, 3]), rng.integers(0, 30, (4, 8)),
                             rng.integers(0, 60, (6, 8)), jcfg.tokens)
    return jcfg, params, convert_params(params, "cpu"), asr


def _engines(model, **kw):
    jcfg, params, tparams, _ = model
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_quant") != "on":
        jkw["cache_dtype"], tkw["cache_dtype"] = jnp.float32, torch.float32
    return (jdecode.DecodeEngine(params, jcfg, max_frames=FRAMES,
                                 buckets=(64,), **jkw),
            decode.DecodeEngine(tparams, UnifiedModelConfig.tiny(),
                                max_frames=FRAMES, buckets=(64,), **tkw))


@pytest.fixture(scope="module")
def engines(model):
    return _engines(model)


def _leaves(tree):
    """The port's cache tensors in JAX's tree order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


@pytest.mark.parametrize("lists", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reorder_matches_jax(engines, lists, dtype):
    jeng, _ = engines
    cfg = UnifiedModelConfig.tiny()
    jc = junified.init_caches(jeng.cfg, 4, dtype=getattr(jnp, dtype),
                              seq_len=16, as_lists=lists)
    tc = unified.init_caches(cfg, 4, dtype=getattr(torch, dtype), seq_len=16,
                             as_lists=lists, device="cpu")
    jl, treedef = jax.tree_util.tree_flatten(jc)
    tl = _leaves(tc)
    assert [a.shape for a in jl] == [tuple(t.shape) for t in tl]
    rng = np.random.default_rng(0)
    filled = []
    for a, t in zip(jl, tl):
        v = (rng.integers(-127, 128, a.shape) if a.dtype == jnp.int8
             else rng.standard_normal(a.shape)).astype(np.float32)
        t.copy_(torch.from_numpy(v).to(t.dtype))
        filled.append(jnp.asarray(v, a.dtype))
    jc = jax.tree_util.tree_unflatten(treedef, filled)
    order = np.array([2, 2, 0, 3])
    reorder_fn = jeng._get_host_step(64, 4)[2]
    want = jax.tree_util.tree_leaves(reorder_fn(jc, jnp.asarray(order,
                                                                jnp.int32)))
    views = [t.data_ptr() for t in tl]
    assert reorder(tc, torch.from_numpy(order)) is tc
    got = _leaves(tc)
    assert [t.data_ptr() for t in got] == views     # the same buffers
    for a, t in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      t.float().numpy())
    assert isinstance(tc.backbone.k[0] if lists else tc.backbone.k,
                      QuantKV) == (dtype == "int8")


def test_beam_one_is_greedy(engines, model):
    _, teng = engines
    g, m = model[3]
    np.testing.assert_array_equal(teng.generate_text_beam(g, m, beam_size=1),
                                  teng.generate_text(g, m, topk=1))


def test_beam_three_matches_jax(engines, model):
    jeng, teng = engines
    g, m = model[3]
    want = jeng.generate_text_beam(g, m, beam_size=3)
    got = teng.generate_text_beam(g, m, beam_size=3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, teng.generate_text(g, m, topk=1))
    assert teng.last_policy["cache_len"] == 128


def test_beam_on_the_int8_cache(model):
    jeng, teng = _engines(model, kv_quant="on")
    g, m = model[3]
    want = jeng.generate_text_beam(g, m, beam_size=2, max_steps=3)
    got = teng.generate_text_beam(g, m, beam_size=2, max_steps=3)
    assert teng.last_policy["kv_dtype"] == torch.int8
    assert got.ndim == 1 and len(got) <= 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("topk", [1, 5])
def test_ngram_blocked_text_matches_jax(engines, model, n, topk):
    jeng, teng = engines
    g, m = model[3]
    kw = dict(topk=topk, temperature=0.9, seed=3, no_repeat_ngram=n)
    want = jeng.generate_text(g, m, **kw)
    got = teng.generate_text(g, m, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(got) == FRAMES
    grams = [tuple(got[i:i + n]) for i in range(FRAMES - n + 1)]
    assert len(set(grams)) == len(grams)                 # nothing repeats
    if topk == 1:               # and without blocking it would
        free = teng.generate_text(g, m, topk=1)
        assert len({tuple(free[i:i + n]) for i in range(FRAMES - n + 1)}) \
            < FRAMES - n + 1


def test_banned_ngram_helper():
    assert decode._banned_ngram_tokens([1, 2, 3, 1, 2], 3) == {3}
    assert decode._banned_ngram_tokens([1, 1, 1], 2) == {1}
    assert decode._banned_ngram_tokens([1, 2, 3], 2) == set()
