"""The port's `DecodeEngine` at its own defaults against the JAX engine, on
`tiny(max_seq_len=1024)` under greedy decoding (topk=1). The other two
policies run the same tests from `test_torch_kv_engine_deferred.py` and
`test_torch_kv_engine_f32.py`, so that a parallel run spreads the three
policies over three workers.

Both engines are built with no policy argument: ``max_frames=500`` and the
prompts in bucket 64 give a 768-slot cache, where "auto" picks the int8 KV
cache and prefix-bounded reads of block 128 (six levels, 128 to 768); the
frames run until the cache's end or EOS. The same with deferred KV writes,
and with the int8 cache turned off (f32 cache, block 128). Parameters come
from the JAX package through `convert/from_jax.py`.

Tokens must be identical. One exception, stated and checked: with the f32
cache, a text step whose two best logits lie closer than the two packages'
f32 agreement (1e-5 x max|logit|, the parity tolerance of every f32 test
here) is a tie that either side may break. The comparison then requires
every token before it to be identical and certifies the tie on JAX's own
teacher-forced logits at that step (`unified.forward_text` over the shared
prefix). The int8 paths need no such rule: their integer sums are exact on
both sides.
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

TIE = 1e-5
POLICIES = {
    "defaults": ({}, {}),
    "deferred": ({"kv_write": "deferred"}, {"kv_write": "deferred"}),
    "kv_quant_off": ({"kv_quant": "off", "cache_dtype": jnp.float32},
                     {"kv_quant": "off", "cache_dtype": torch.float32}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops are far too small to gain from intra-op threads;
    one thread keeps a parallel run's workers from crowding each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(max_seq_len=1024)
    params = junified.init_params(jax.random.PRNGKey(3), jcfg)
    ts = jcfg.tokens
    tts = jtasks.prepare_tts(np.array([1, 5, 6, 7]), np.array([3, 10, 2]), ts)
    rng = np.random.default_rng(0)
    asr = jtasks.prepare_asr(np.array([4, 8, 9]), rng.integers(0, 30, (5, 8)),
                             rng.integers(0, 60, (6, 8)), ts)
    return jcfg, params, convert_params(params, "cpu"), tts, asr


def build(name, model):
    """The JAX and the port's engine under policy ``name``, one of each,
    reused for both modes."""
    jcfg, params, tparams, _, _ = model
    jkw, tkw = POLICIES[name]
    jeng = jdecode.DecodeEngine(params, jcfg, buckets=(64,), **jkw)
    teng = decode.DecodeEngine(tparams, UnifiedModelConfig.tiny(max_seq_len=1024),
                               buckets=(64,), **tkw)
    return name, jeng, teng


@pytest.fixture(scope="module", params=["defaults"])
def engines(request, model):
    return build(request.param, model)


def _policy_is(teng, name):
    p = teng.last_policy
    assert p["cache_len"] == 768 and p["attn_block"] == 128
    assert p["kv_dtype"] == (torch.float32 if name == "kv_quant_off"
                             else torch.int8)
    assert p["kv_write"] == ("deferred" if name == "deferred" else "inline")


def test_generate_audio_identical_to_jax(engines, model):
    name, jeng, teng = engines
    g, m = model[3]
    jr, js = jeng.generate_audio(g, m, topk=1)
    tr, tsem = teng.generate_audio(g, m, topk=1)
    _policy_is(teng, name)
    assert teng.last_steps > 256        # past two prefix-level boundaries
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tsem, js)


def _tie_at(model, toks, step, a, b):
    """JAX's teacher-forced text logits at decode ``step`` after the shared
    tokens ``toks[:step]``: tokens ``a`` and ``b`` lie within TIE x max."""
    jcfg, params, _, _, (g, m) = model
    fb = np.zeros((step, g.shape[1]), g.dtype)
    fb[:, -1] = toks[:step]
    fm = np.zeros((step, g.shape[1]), bool)
    fm[:, -1] = True
    grid, mask = np.concatenate([g, fb]), np.concatenate([m, fm])
    logits = np.asarray(junified.forward_text(
        params, jcfg, jnp.asarray(grid[None]), jnp.asarray(mask[None])))[0]
    lg = logits[g.shape[0] - 1 + step]
    assert {a, b} <= set(np.argsort(lg)[-2:].tolist())
    return abs(lg[a] - lg[b]) <= TIE * np.abs(lg).max()


def test_generate_text_identical_to_jax(engines, model):
    name, jeng, teng = engines
    g, m = model[4]
    jt = jeng.generate_text(g, m, topk=1)
    tt = teng.generate_text(g, m, topk=1)
    _policy_is(teng, name)
    assert teng.last_steps > 256
    n = min(len(jt), len(tt))
    diff = np.nonzero(jt[:n] != tt[:n])[0]
    if name == "kv_quant_off" and diff.size:
        d = int(diff[0])
        assert _tie_at(model, jt, d, int(jt[d]), int(tt[d])), (
            f"text token {d} differs ({jt[d]} vs {tt[d]}) without a tie")
        return
    np.testing.assert_array_equal(tt, jt)


def test_ragged_batch_key_valid_matches_jax(model):
    """`unified.prefill` and `decode_hidden` with a ragged batch-2
    ``key_valid`` (row 1 left-padded by 3 slots), int8 cache and block-16
    prefix reads, against JAX within 1e-5 x max|jax|."""
    jcfg, params, tparams, (g, m), _ = model
    tcfg = UnifiedModelConfig.tiny(max_seq_len=1024)
    s, pad = 48, 3
    grid = np.zeros((2, s, g.shape[1]), g.dtype)
    mask = np.zeros((2, s, g.shape[1]), bool)
    L = g.shape[0]
    grid[0, :L], mask[0, :L] = g, m
    grid[1, pad:pad + L], mask[1, pad:pad + L] = g, m
    valid = np.ones((2, s), bool)
    valid[1, :pad] = False
    jc = junified.init_caches(jcfg, 2, dtype=jnp.int8, seq_len=s)
    tc = unified.init_caches(tcfg, 2, dtype=torch.int8, seq_len=s, device="cpu")
    prompt = L - 1 + pad
    jprefill = jax.jit(lambda p, t, m_, c, kv: junified.prefill(
        p, jcfg, t, m_, c, key_valid=kv))
    jstep = jax.jit(lambda p, t, m_, c, pos, kv: junified.decode_hidden(
        p, jcfg, t, m_, c, pos, key_valid=kv, attn_block=16))
    jc = jprefill(params, jnp.asarray(grid[:, :prompt]),
                  jnp.asarray(mask[:, :prompt]), jc,
                  jnp.asarray(valid[:, :prompt]))
    unified.prefill(tparams, tcfg, torch.from_numpy(grid[:, :prompt]),
                    torch.from_numpy(mask[:, :prompt]), tc,
                    key_valid=torch.from_numpy(valid[:, :prompt]))
    tok = grid[:, prompt:prompt + 1]
    msk = mask[:, prompt:prompt + 1]
    for step in range(3):
        pos = prompt + step
        jh, jc = jstep(params, jnp.asarray(tok), jnp.asarray(msk), jc,
                       jnp.int32(pos), jnp.asarray(valid))
        with torch.no_grad():
            th, _ = unified.decode_hidden(
                tparams, tcfg, torch.from_numpy(tok), torch.from_numpy(msk), tc,
                torch.tensor([pos]), key_valid=torch.from_numpy(valid),
                attn_block=16, host_pos=pos)
        ref = np.asarray(jh)
        np.testing.assert_allclose(th.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        tok = np.zeros_like(tok)
        tok[:, 0, -1] = 7 + step
        msk = np.zeros_like(msk)
        msk[:, 0, -1] = True
    np.testing.assert_array_equal(tc.backbone.k.q.numpy(),
                                  np.asarray(jc.backbone.k.q))
