"""The port's MoE MLP (`models/gpt.py` `_moe_mlp`, the dense combine over
stacked experts) against the JAX package and a direct re-execution of the
reference's routing, and the port's GPT core against HuggingFace's
`LlamaModel` (built from a `LlamaConfig`, random weights, no download):
the counterparts of `tests/test_gpt_options.py`'s MoE cases and
`tests/test_gpt_parity.py`'s four cases.

Tolerances: the JAX package's own (2e-4 for MoE, 2e-5 against HF, 1e-5
for prefill / decode against the full forward), in float32 (JAX at matmul
precision "highest").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import GPTConfig as JGPTConfig
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.ops.kv_cache import init_cache as jinit_cache

from uniaudio2_tpu_torch.config import GPTConfig, RoPEAdjustments
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.models import gpt
from uniaudio2_tpu_torch.ops.kv_cache import init_cache

MOE_TOL = dict(rtol=2e-4, atol=2e-4)
HF_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    base = dict(name="tiny-opts", block_size=64, vocab_size=97,
                padding_multiple=8, n_layer=3, n_embd=32, n_head=4,
                n_query_groups=2, intermediate_size=48, rope_adjustments=None)
    base.update(kw)
    return JGPTConfig(**base), GPTConfig(**base)


def test_moe_mlp_matches_reference_torch():
    """`_moe_mlp` against JAX's and against the reference's routing
    (`LLaMAMoE.forward`: top-k, softmax, per-expert gather)."""
    jcfg, tcfg = _cfgs(n_expert=4, n_expert_per_token=2,
                       moe_intermediate_size=40)
    jp = jgpt.init_params(jax.random.PRNGKey(3), jcfg)
    tp_ = convert_params(jp, "cpu")
    layer0 = {k: v[0] for k, v in tp_["layers"].items()}
    b, t = 2, 5
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (b, t, 32)))
    ours = gpt._moe_mlp(layer0, torch.from_numpy(x), tcfg).numpy()
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    np.testing.assert_allclose(
        ours, np.asarray(jgpt._moe_mlp(jl0, jnp.asarray(x), jcfg)), **MOE_TOL)
    xt = torch.from_numpy(x).reshape(-1, 32)
    router = xt @ layer0["moe_gate_w"]
    probs, indices = torch.topk(router, 2)
    probs = probs.softmax(dim=1, dtype=torch.float)
    masks = (indices.unsqueeze(-1) == torch.arange(4)).permute(2, 0, 1)
    y = torch.zeros_like(xt)
    for e in range(4):
        token_idx, expert_idx = torch.where(masks[e])
        xe = xt[token_idx]
        h = torch.nn.functional.silu(xe @ layer0["fc1_w"][e]) \
            * (xe @ layer0["fc2_w"][e])
        y[token_idx] += probs[token_idx, expert_idx, None] \
            * (h @ layer0["mlp_proj_w"][e])
    np.testing.assert_allclose(ours, y.reshape(b, t, 32).numpy(), **MOE_TOL)


def test_moe_forward_and_decode_run():
    """An MoE config through forward and through prefill + cached decode:
    the same hidden states, JAX's forward, and the port's own init makes
    JAX's tree shapes (experts stacked on axis 1)."""
    jcfg, tcfg = _cfgs(n_expert=4, n_expert_per_token=2)
    jp = jgpt.init_params(jax.random.PRNGKey(5), jcfg)
    tp_ = convert_params(jp, "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(6), (1, 6, 32)))
    xt = torch.from_numpy(x)
    full = gpt.forward(tp_, tcfg, xt)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jgpt.forward(jp, jcfg, jnp.asarray(x))),
        **MOE_TOL)
    cache = init_cache(tcfg, 1, 8, dtype=torch.float32, device="cpu")
    h_pre, cache = gpt.prefill(tp_, tcfg, xt[:, :3], cache)
    hs = [h_pre[:, i] for i in range(3)]
    for i in range(3, 6):
        h_i, cache = gpt.decode_step(tp_, tcfg, xt[:, i:i + 1], cache, i)
        hs.append(h_i[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(hs, 1).numpy(),
                               **MOE_TOL)
    mine = gpt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    for k, v in mine["layers"].items():
        assert tuple(v.shape) == shapes["layers"][k], k
    assert mine["layers"]["fc1_w"].shape == (3, 4, 32, 48)


# ---------------------------------------------------------------------------
# The GPT core against HuggingFace's LlamaModel
# ---------------------------------------------------------------------------


def _hf_tiny_llama(rope_scaling=None):
    from transformers import LlamaConfig, LlamaModel

    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, mlp_bias=False, rope_scaling=rope_scaling,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = LlamaModel(cfg)
    model.eval()
    return model


def _convert_hf_weights(hf_model, n_layer):
    """HF Llama state dict -> the port's stacked-layer tree."""
    sd = {k: v.detach() for k, v in hf_model.state_dict().items()}

    def stack(fmt, t=False):
        return torch.stack([sd[fmt.format(i)].T if t else sd[fmt.format(i)]
                            for i in range(n_layer)])

    qkv = torch.stack([torch.cat([sd[f"layers.{i}.self_attn.{p}_proj.weight"]
                                  for p in "qkv"], 0).T
                       for i in range(n_layer)])
    return {
        "layers": {
            "norm1_w": stack("layers.{}.input_layernorm.weight"),
            "qkv_w": qkv,
            "attn_proj_w": stack("layers.{}.self_attn.o_proj.weight", True),
            "norm2_w": stack("layers.{}.post_attention_layernorm.weight"),
            "fc1_w": stack("layers.{}.mlp.gate_proj.weight", True),
            "fc2_w": stack("layers.{}.mlp.up_proj.weight", True),
            "mlp_proj_w": stack("layers.{}.mlp.down_proj.weight", True),
        },
        "ln_f_w": sd["norm.weight"],
        "wte": sd["embed_tokens.weight"],
    }


OUR_CFG = dict(name="parity", block_size=512, vocab_size=256,
               padded_vocab_size=256, n_layer=2, n_embd=64, n_head=4,
               n_query_groups=2, intermediate_size=128, rope_base=10000.0,
               rope_adjustments=None, has_lm_head=False)


def test_forward_matches_hf_llama():
    hf = _hf_tiny_llama()
    params = _convert_hf_weights(hf, 2)
    x = np.random.default_rng(0).normal(size=(2, 10, 64)).astype(np.float32)
    with torch.no_grad():
        ref = hf(inputs_embeds=torch.from_numpy(x)).last_hidden_state.numpy()
        ours = gpt.forward(params, GPTConfig(**OUR_CFG),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, **HF_TOL)


def test_forward_matches_hf_llama3_rope_scaling():
    scaling = dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=128)
    hf = _hf_tiny_llama(rope_scaling=scaling)
    params = _convert_hf_weights(hf, 2)
    cfg = GPTConfig(**dict(OUR_CFG, rope_adjustments=RoPEAdjustments(
        factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_seq_len=128)))
    x = np.random.default_rng(1).normal(size=(1, 16, 64)).astype(np.float32)
    with torch.no_grad():
        ref = hf(inputs_embeds=torch.from_numpy(x)).last_hidden_state.numpy()
        ours = gpt.forward(params, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, **HF_TOL)


def test_prefill_decode_matches_full_forward():
    """Prefill(8) + step-by-step decode reproduce the full forward, and the
    port's full forward JAX's, on the tiny backbone."""
    cfg = GPTConfig.from_name("tiny-backbone", has_lm_head=False)
    jcfg = JGPTConfig.from_name("tiny-backbone", has_lm_head=False)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jp, "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 12, 64)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = gpt.forward(params, cfg, xt)
        np.testing.assert_allclose(
            full.numpy(), np.asarray(jgpt.forward(jp, jcfg, jnp.asarray(x))),
            rtol=1e-4, atol=1e-4)
        cache = init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
        h_pre, cache = gpt.prefill(params, cfg, xt[:, :8], cache)
        np.testing.assert_allclose(h_pre.numpy(), full[:, :8].numpy(),
                                   **STEP_TOL)
        for t in range(8, 12):
            h_t, cache = gpt.decode_step(params, cfg, xt[:, t:t + 1], cache,
                                         t)
            np.testing.assert_allclose(h_t[:, 0].numpy(), full[:, t].numpy(),
                                       **STEP_TOL)


def test_prefill_with_padding_is_consistent():
    """Decode after a padded prefill equals decode after an exact one, as
    in JAX (whose caches the port's match)."""
    cfg = GPTConfig.from_name("tiny-backbone", has_lm_head=False)
    jcfg = JGPTConfig.from_name("tiny-backbone", has_lm_head=False)
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert_params(jp, "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 6, 64)))
    x_pad = np.concatenate([x, np.zeros((1, 10, 64), np.float32)], 1)
    nxt = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 1, 64)))
    outs = []
    with torch.no_grad():
        for xx in (x, x_pad):
            cache = init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
            gpt.prefill(params, cfg, torch.from_numpy(xx), cache)
            h, _ = gpt.decode_step(params, cfg, torch.from_numpy(nxt), cache,
                                   6)
            outs.append(h.numpy())
    np.testing.assert_allclose(outs[0], outs[1], **STEP_TOL)
    jc = jinit_cache(jcfg, 1, 32, jnp.float32)
    _, jc = jgpt.prefill(jp, jcfg, jnp.asarray(x_pad), jc)
    jh, _ = jgpt.decode_step(jp, jcfg, jnp.asarray(nxt), jc, jnp.int32(6))
    np.testing.assert_allclose(outs[1], np.asarray(jh), rtol=1e-4, atol=1e-4)
