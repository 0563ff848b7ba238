"""`models/gpt.py` and `models/unified.py` of the port against the JAX
package on tiny configs in f32 (JAX at matmul precision "highest"), with
float weights and with int4all serving weights bridged from JAX. Hidden
states and logits agree to summation order: rtol/atol 1e-4 after a whole
stack (1e-5 per op, a few dozen ops deep); greedy frames are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import GPTConfig as JaxGPTConfig
from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.ops import kv_cache as jkv
from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch.config import GPTConfig, UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.ops import kv_cache

TOL = dict(rtol=1e-4, atol=1e-4)
INT4ALL = ("backbone", "decoder", "understanding_expert", "generation_expert",
           "audio_head", "projection_w")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()


@pytest.mark.parametrize("weights", ["float", "int4i"])
@pytest.mark.parametrize("as_lists", [False, True])
def test_gpt_prefill_and_decode_steps(weights, as_lists):
    name = "tiny-backbone"
    jcfg, tcfg = JaxGPTConfig.from_name(name), GPTConfig.from_name(name)
    jp = jgpt.init_params(jax.random.PRNGKey(1), jcfg)
    if weights == "int4i":
        jp = jgpt.unstack_layers(jq.quantize_gpt_params(jp, bits=4))
        jp["layers"] = [{k: jq.to_interleaved(v) for k, v in layer.items()}
                        for layer in jp["layers"]]
    elif as_lists:      # JAX pairs list caches with unrolled layers
        jp = jgpt.unstack_layers(jp)
    tp = convert_params(jp, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 1, 64)).astype(np.float32)
    jc = jkv.init_cache(jcfg, 2, 16, jnp.float32, as_lists)
    tc = kv_cache.init_cache(tcfg, 2, 16, torch.float32, as_lists,
                                device="cpu")
    jh, jc = jgpt.prefill(jp, jcfg, jnp.asarray(x), jc)
    th, tc = gpt.prefill(tp, tcfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    for i, s in enumerate(steps):
        pos = 5 + i
        jh, jc = jgpt.decode_step(jp, jcfg, jnp.asarray(s), jc, jnp.int32(pos))
        tpos = pos if i % 2 else torch.tensor([pos])      # int and tensor
        th, tc = gpt.decode_step(tp, tcfg, torch.from_numpy(s), tc, tpos)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    jk = jc.k[0] if as_lists else jc.k
    tk = tc.k[0] if as_lists else tc.k
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)


def test_gpt_forward_and_lm_head():
    jcfg = JaxGPTConfig.from_name("tiny-backbone")
    tcfg = GPTConfig.from_name("tiny-backbone")
    jp = jgpt.init_params(jax.random.PRNGKey(2), jcfg)
    tp = convert_params(jp, "cpu")
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    jh = jgpt.forward(jp, jcfg, jnp.asarray(x))
    th = gpt.forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(gpt.lm_head(tp, th, tcfg).numpy(),
                               _np(jgpt.lm_head(jp, jh, jcfg)), **TOL)
    tok = np.array([[1, 5, 900]])
    np.testing.assert_array_equal(gpt.embed(tp, torch.from_numpy(tok)).numpy(),
                                  _np(jgpt.embed(jp, jnp.asarray(tok))))


def test_moe_not_ported():
    """MoE layers, once refused here, now ported: the init makes JAX's tree
    and the forward gives JAX's hidden states on it."""
    cfg = GPTConfig.from_name("tiny-expert", n_expert=2, n_expert_per_token=1)
    jcfg = JaxGPTConfig.from_name("tiny-expert", n_expert=2,
                                  n_expert_per_token=1)
    mine = gpt.init_params(cfg, torch.Generator(), device="cpu")
    jp = jgpt.init_params(jax.random.PRNGKey(2), jcfg)
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: v.shape for k, v in jp["layers"].items()}
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    th = gpt.forward(convert_params(jp, "cpu"), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(),
                               _np(jgpt.forward(jp, jcfg, jnp.asarray(x))),
                               **TOL)


@pytest.fixture(scope="module", params=["float", "int4all"])
def models(request):
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(5), jcfg)
    if request.param == "int4all":
        jp = junified.prepare_serving_params(
            jq.quantize_unified_params(jp, int4_modules=INT4ALL),
            dtype=jnp.float32, cfg=jcfg)
    ts = jcfg.tokens
    g, m = jtasks.prepare_tts(np.array([1, 5, 6]), np.array([3, 10, 2]), ts)
    grid = np.zeros((1, 16, 9), np.int64)
    mask = np.zeros((1, 16, 9), bool)
    grid[0, :len(g)], mask[0, :len(g)] = g, m
    return jcfg, jp, UnifiedModelConfig.tiny(), convert_params(jp, "cpu"), grid, mask, len(g)


def test_unified_prefill_and_decode_frame(models):
    jcfg, jp, tcfg, tp, grid, mask, length = models
    jc = junified.init_caches(jcfg, 1, dtype=jnp.float32, seq_len=32)
    tc = unified.init_caches(tcfg, 1, dtype=torch.float32, seq_len=32,
                             device="cpu")
    jc = junified.prefill(jp, jcfg, jnp.asarray(grid[:, :-1]),
                          jnp.asarray(mask[:, :-1]), jc)
    tc = unified.prefill(tp, tcfg, torch.from_numpy(grid[:, :-1]),
                         torch.from_numpy(mask[:, :-1]), tc)
    last = length - 1
    jt, jm = jnp.asarray(grid[:, last:last + 1]), jnp.asarray(mask[:, last:last + 1])
    tt, tm = torch.from_numpy(grid[:, last:last + 1]), torch.from_numpy(mask[:, last:last + 1])
    jh, _ = junified.decode_hidden(jp, jcfg, jt, jm, jc, jnp.int32(last))
    th, _ = unified.decode_hidden(tp, tcfg, tt, tm, tc, torch.tensor([last]))
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(
        gpt.lm_head(tp["backbone"], th, tcfg.backbone).numpy(),
        _np(jgpt.lm_head(jp["backbone"], jh, jcfg.backbone)), **TOL)


@pytest.mark.parametrize("use_cfg", [False, True])
def test_decode_frame_greedy_identical(models, use_cfg):
    jcfg, jp, tcfg, tp, grid, mask, length = models
    b = 2 if use_cfg else 1
    grid, mask = np.repeat(grid, b, 0), np.repeat(mask, b, 0)
    jc = junified.init_caches(jcfg, b, dtype=jnp.float32, seq_len=32)
    tc = unified.init_caches(tcfg, b, dtype=torch.float32, seq_len=32,
                             device="cpu")
    jc = junified.prefill(jp, jcfg, jnp.asarray(grid[:, :-1]),
                          jnp.asarray(mask[:, :-1]), jc)
    tc = unified.prefill(tp, tcfg, torch.from_numpy(grid[:, :-1]),
                         torch.from_numpy(mask[:, :-1]), tc)
    last = length - 1
    kw = dict(temperature=1.0, topk=1, use_cfg=use_cfg, cfg_scale=1.5)
    jf, _ = junified.decode_frame(
        jp, jcfg, jnp.asarray(grid[:, last:last + 1]),
        jnp.asarray(mask[:, last:last + 1]), jc, jnp.int32(last),
        jax.random.PRNGKey(0), forbid_prefix=jnp.int32(0), **kw)
    tf, _ = unified.decode_frame(
        tp, tcfg, torch.from_numpy(grid[:, last:last + 1]),
        torch.from_numpy(mask[:, last:last + 1]), tc, torch.tensor([last]),
        None, forbid_prefix=0, **kw)
    np.testing.assert_array_equal(tf.numpy(), _np(jf))


def test_forward_text(models):
    jcfg, jp, tcfg, tp, grid, mask, _ = models
    np.testing.assert_allclose(
        unified.forward_text(tp, tcfg, torch.from_numpy(grid),
                             torch.from_numpy(mask)).numpy(),
        _np(junified.forward_text(jp, jcfg, jnp.asarray(grid),
                                  jnp.asarray(mask))), **TOL)
