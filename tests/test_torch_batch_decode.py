"""The port's batched decoding against the JAX `DecodeEngine` on `tiny()`.

Greedy (topk=1) tokens must be IDENTICAL: both sides run in f32 (conftest
sets JAX's matmul precision to "highest"). Ragged prompts are left-padded
to one bucket, so a row's tokens must also equal the same item decoded
alone. The cases of `tests/test_batched_decode.py` run against the JAX
engine, plus 8 rows at the engine's defaults (where "auto" picks the int8
KV cache at batch 8) and deferred KV writes. Sampled tokens cannot match
JAX's (other random streams); under per-row seeds a row's tokens must not
change with the batch around it (`tests/test_server.py`'s case). The
per-pair ``forbid_prefix`` of the local decoder is held to JAX's
`_local_decoder_generate` on two CFG pairs in different phases.

Parameters come from the JAX package through `convert/from_jax.py`. Every
JAX program compiled here is one (mode, rows, policy): six in all.
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
from uniaudio2_tpu_torch.ops.sampling import RowKeys

FRAMES = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny()
    params = junified.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, convert_params(params, "cpu")


def _engines(model, **kw):
    jcfg, params, tparams = model
    jkw = dict(kw)
    tkw = dict(kw)
    if "cache_dtype" not in kw:
        jkw["cache_dtype"], tkw["cache_dtype"] = jnp.float32, torch.float32
    jeng = jdecode.DecodeEngine(params, jcfg, max_frames=FRAMES,
                                buckets=(64,), **jkw)
    teng = decode.DecodeEngine(tparams, UnifiedModelConfig.tiny(),
                               max_frames=FRAMES, buckets=(64,), **tkw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(model):
    return _engines(model)


def _items(ts, n, seed=0):
    """Ragged ASR prompts (as `tests/test_batched_decode.py::_items`)."""
    rng = np.random.default_rng(seed)
    return [jtasks.prepare_asr(np.array([1, 2, 3]),
                               rng.integers(0, 30, (3 + i, 8)),
                               rng.integers(0, 60, (5 + 2 * i, 8)), ts)
            for i in range(n)]


def _cfg_items(ts, n, seed=0):
    rng = np.random.default_rng(seed)
    items, negs = [], []
    for i in range(n):
        prompt = rng.integers(1, 20, (3 + i,))
        text = rng.integers(1, 20, (4 + i,))
        items.append(jtasks.prepare_tts(prompt, text, ts))
        negs.append(jtasks.prepare_tts_cfg_negative(prompt, text, ts))
    return items, negs


def _same_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same_lists(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_text_batch_matches_jax_and_single(engines):
    """Left-padded batched greedy decode: JAX's batch token for token, and
    each row the port's own unbatched `generate_text` of its item."""
    jeng, teng = engines
    items = _items(jeng.cfg.tokens, 3)
    got = teng.generate_text_batch(items, topk=1, temperature=1.0)
    _same_lists(got, jeng.generate_text_batch(items, topk=1, temperature=1.0))
    assert teng.last_policy["cache_len"] == 128
    assert teng.last_policy["kv_dtype"] == torch.float32
    for (grid, mask), row in zip(items, got):
        np.testing.assert_array_equal(
            row, teng.generate_text(grid, mask, topk=1, temperature=1.0))


def test_audio_batch_shapes_match_jax(engines):
    jeng, teng = engines
    items = _items(jeng.cfg.tokens, 2, seed=3)
    got = teng.generate_audio_batch(items, topk=1, temperature=1.0)
    _same_lists(got, jeng.generate_audio_batch(items, topk=1,
                                               temperature=1.0))
    for reason, semantic in got:
        assert reason.shape[0] == 8 and semantic.shape[0] == 8


def test_cfg_single_item_matches_unbatched_cfg(engines):
    """One CFG utterance as a batch of 2 rows: the unbatched CFG path's
    tokens (`test_batched_cfg_single_matches_unbatched_cfg`)."""
    jeng, teng = engines
    items, negs = _cfg_items(jeng.cfg.tokens, 1)
    (grid, mask), (ng, nm) = items[0], negs[0]
    single = teng.generate_audio(grid, mask, topk=1, temperature=1.0,
                                 use_cfg=True, cfg_scale=1.5, neg_grid=ng,
                                 neg_mask=nm)
    batched = teng.generate_audio_batch(items, topk=1, temperature=1.0,
                                        use_cfg=True, cfg_scale=1.5,
                                        neg_items=negs)
    _same_lists(batched[0], single)
    _same_lists(batched, jeng.generate_audio_batch(
        items, topk=1, temperature=1.0, use_cfg=True, cfg_scale=1.5,
        neg_items=negs))


def test_cfg_pairs_independent(engines):
    """Two CFG utterances in one batch: each its own 1-item run and JAX's
    batch (`test_batched_cfg_pairs_independent`)."""
    jeng, teng = engines
    items, negs = _cfg_items(jeng.cfg.tokens, 2, seed=7)
    kw = dict(topk=1, temperature=1.0, use_cfg=True, cfg_scale=1.5)
    batched = teng.generate_audio_batch(items, neg_items=negs, **kw)
    _same_lists(batched, jeng.generate_audio_batch(items, neg_items=negs, **kw))
    for i in range(2):
        solo = teng.generate_audio_batch([items[i]], neg_items=[negs[i]], **kw)
        _same_lists(batched[i], solo[0])


def test_cfg_needs_matching_negatives(engines):
    _, teng = engines
    items, negs = _cfg_items(teng.cfg.tokens, 2)
    with pytest.raises(ValueError):
        teng.generate_audio_batch(items, use_cfg=True, neg_items=negs[:1])
    with pytest.raises(ValueError):
        teng.generate_audio_batch(items, use_cfg=True,
                                  neg_items=[negs[1], negs[0]])


@pytest.mark.parametrize("kv_write", ["inline", "deferred"])
def test_eight_rows_at_the_defaults(model, kv_write):
    """8 rows at the engine's own policies: "auto" turns the int8 KV cache
    on at batch 8 (the 128-slot cache alone would not), in both packages;
    deferred KV writes run the stacked cache."""
    kw = {} if kv_write == "inline" else {"kv_write": "deferred"}
    jeng, teng = _engines(model, **kw)
    items = _items(jeng.cfg.tokens, 8, seed=11)
    mode = "text" if kv_write == "inline" else "audio"
    fn = f"generate_{mode}_batch"
    got = getattr(teng, fn)(items, topk=1, temperature=1.0)
    assert teng.last_policy["kv_dtype"] == torch.int8
    assert teng.last_policy["kv_write"] == kv_write
    _same_lists(got, getattr(jeng, fn)(items, topk=1, temperature=1.0))


def test_per_row_seeds_independent_of_the_batch(engines):
    """`tests/test_server.py::test_per_row_seeds_direct_engine` on the
    port: seeds [42] alone and [42, 1, 2] give row 0 the same sampled
    tokens, text and audio; seed 43 differs; a CFG pair samples from its
    item's stream, whatever pair shares the batch."""
    _, teng = engines
    ts = teng.cfg.tokens
    items = _items(ts, 3)
    kw = dict(temperature=0.9, topk=5)
    solo = teng.generate_text_batch(items[:1], seeds=[42], **kw)
    batched = teng.generate_text_batch(items, seeds=[42, 1, 2], **kw)
    np.testing.assert_array_equal(solo[0], batched[0])
    other = teng.generate_text_batch(items[:1], seeds=[43], **kw)
    assert not np.array_equal(solo[0], other[0])
    solo_a = teng.generate_audio_batch(items[:1], seeds=[42], **kw)
    batched_a = teng.generate_audio_batch(items, seeds=[42, 1, 2], **kw)
    _same_lists(solo_a[0], batched_a[0])
    cfg_items, negs = _cfg_items(ts, 2, seed=5)
    ckw = dict(kw, use_cfg=True, cfg_scale=1.5)
    pair = teng.generate_audio_batch(cfg_items[:1], neg_items=negs[:1],
                                     seeds=[42], **ckw)
    pairs = teng.generate_audio_batch(cfg_items, neg_items=negs,
                                      seeds=[42, 7], **ckw)
    _same_lists(pair[0], pairs[0])


def test_row_keys_are_a_function_of_the_row():
    """A row's draws depend on its seed and the folds alone; other rows,
    other seeds and other folds give other numbers."""
    a = RowKeys.from_seeds([42], "cpu").fold(3).fold(1)
    b = RowKeys.from_seeds([7, 42, 9], "cpu").fold(3).fold(1)
    assert torch.equal(a.uniform(50)[0], b.uniform(50)[1])
    u = b.uniform(50)
    assert not torch.equal(u[0], u[1])
    assert not torch.equal(u[1], RowKeys.from_seeds([7, 42, 9], "cpu")
                           .fold(4).fold(1).uniform(50)[1])
    assert float(u.min()) > 0 and float(u.max()) < 1


def test_local_decoder_per_pair_forbid_prefix(model):
    """Two CFG pairs, one in the reasoning phase (prefix 0) and one in the
    semantic phase (prefix ``audio_reason_card``), greedy: JAX's
    `_local_decoder_generate` with its per-pair ``fp_pair``."""
    jcfg, params, tparams = model
    card = jcfg.tokens.audio_reason_card
    rng = np.random.default_rng(4)
    h = rng.standard_normal((4, jcfg.backbone.n_embd)).astype(np.float32)
    forbid = np.array([0, 0, card, card])
    want = np.asarray(junified._local_decoder_generate(
        params, jcfg, jnp.asarray(h), jax.random.PRNGKey(0), temperature=1.0,
        topk=1, forbid_prefix=jnp.asarray(forbid[:, None], jnp.int32),
        use_cfg=True, cfg_scale=jnp.float32(1.5)))
    got = unified._local_decoder_generate(
        tparams, UnifiedModelConfig.tiny(), torch.from_numpy(h), None,
        temperature=1.0, topk=1,
        forbid_prefix=torch.from_numpy(forbid)[:, None], use_cfg=True,
        cfg_scale=1.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2:] >= card).all() and (got[0::2] == got[1::2]).all()
