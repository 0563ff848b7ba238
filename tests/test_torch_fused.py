"""The fused kernels' plain twins (what the CPU runs) against the JAX
package's composed paths, on one quantized int4 serving layer.

K = 256 so that the port's `can_fuse` gates pass and `gpt._qkv` /
`gpt._mlp_block` really dispatch to `qkv_rope_step` / `fused_swiglu`.
f32: agreement to summation order (rtol/atol 1e-5). bf16: both round the
same f32 products at the same places except ``silu(gate) * up`` (rounded
once in the port, per XLA's fusion in JAX), so within 2 bf16 ulps of the
output's range (atol 2e-2 * max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import GPTConfig as JaxGPTConfig
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.ops import quant as jq
from uniaudio2_tpu.ops.rope import rope_cache as jrope_cache

from uniaudio2_tpu_torch.config import GPTConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.models import gpt
from uniaudio2_tpu_torch.ops import fused_mlp, qkv_step, quant

FIELDS = dict(name="fused-test", block_size=64, vocab_size=512,
              padded_vocab_size=512, n_layer=1, n_embd=256, n_head=4,
              n_query_groups=2, intermediate_size=512, rope_base=10000.0,
              rope_adjustments=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def layer():
    jcfg = JaxGPTConfig(**FIELDS)
    p = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    p["layers"]["norm1_w"] = p["layers"]["norm1_w"] * 1.5
    p["layers"]["norm2_w"] = p["layers"]["norm2_w"] * 0.7
    p = jgpt.unstack_layers(jq.quantize_gpt_params(p, bits=4))
    jl = {k: jq.to_interleaved(v) for k, v in p["layers"][0].items()}
    return jcfg, GPTConfig(**FIELDS), jl, convert_params(jl, "cpu")


def _cast(tree, jd, td):
    j = {k: (v.astype(jd) if k.startswith("norm") else v) for k, v in tree[0].items()}
    t = {k: (v.to(td) if k.startswith("norm") else v) for k, v in tree[1].items()}
    return j, t


def _tol(ref, dtype):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=0, atol=2e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("folded", [True, False])
def test_fused_swiglu_plain_matches_jax_mlp(layer, dtype, folded):
    jcfg, tcfg, jl, tl = layer
    jl, tl = _cast((jl, tl), getattr(jnp, dtype), getattr(torch, dtype))
    x = np.random.default_rng(1).standard_normal((2, 3, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert fused_mlp.can_fuse(tl["fc1_w"], tl["fc2_w"], tl["mlp_proj_w"], tx)
    if folded:
        ref = jgpt._mlp_block(jl, jx, jcfg)
        out = gpt._mlp_block(tl, tx, tcfg)
    else:
        ref = jgpt._mlp(jl, jx, jcfg)
        out = fused_mlp.fused_swiglu(tx, tl["fc1_w"], tl["fc2_w"],
                                     tl["mlp_proj_w"])
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, **_tol(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 2])
def test_qkv_rope_step_plain_matches_jax_qkv(layer, dtype, b):
    jcfg, tcfg, jl, tl = layer
    jl, tl = _cast((jl, tl), getattr(jnp, dtype), getattr(torch, dtype))
    x = np.random.default_rng(2).standard_normal((b, 1, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cos, sin = jrope_cache(16, 64, base=10000.0)
    assert qkv_step.can_fuse(tl["qkv_w"], tx[:, 0], 4, 2, 64)
    ref = jgpt._qkv(jl, jcfg, jx, cos[5:6], sin[5:6],
                    pre_norm=(jl["norm1_w"], 1e-5))
    out = gpt._qkv(tl, tcfg, tx, torch.from_numpy(np.array(cos[5:6])),
                   torch.from_numpy(np.array(sin[5:6])),
                   pre_norm=(tl["norm1_w"], 1e-5))
    for o, r in zip(out, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.float().numpy(), r, **_tol(r, dtype))


def test_can_fuse_gates(layer):
    _, _, _, tl = layer
    x = torch.zeros(2, 256)
    w1, w2, w3 = tl["fc1_w"], tl["fc2_w"], tl["mlp_proj_w"]
    assert fused_mlp.can_fuse(w1, w2, w3, x)
    assert not fused_mlp.can_fuse(w1, w2, w3, torch.zeros(129, 256))
    assert not fused_mlp.can_fuse(w1, w2, w3, torch.zeros(2, 128))
    int8 = quant.quantize(torch.randn(256, 512))
    assert not fused_mlp.can_fuse(int8, int8, w3, x)
    k_split = quant.quantize4(torch.randn(256, 512))
    assert not fused_mlp.can_fuse(k_split, k_split, w3, x)
    chunked = quant.chunk_major(w1, 128)
    assert not fused_mlp.can_fuse(chunked, chunked, w3, x)
    qkv = tl["qkv_w"]
    assert qkv_step.can_fuse(qkv, x, 4, 2, 64)
    assert not qkv_step.can_fuse(qkv, torch.zeros(129, 256), 4, 2, 64)
    assert qkv_step.can_fuse(quant.quantize(torch.randn(256, 512)), x, 4, 2, 64)
    assert not qkv_step.can_fuse(quant.quantize4_cols(torch.randn(256, 512)),
                                 x, 4, 2, 64)          # column-packed
    assert not qkv_step.can_fuse(qkv, x, 3, 1, 128)        # width mismatch
    padded = quant.to_interleaved(quant.quantize4(torch.randn(256, 640)))
    assert not qkv_step.can_fuse(padded, x, 6, 2, 64)      # lane-padded


def test_cpu_wrappers_do_not_count(layer):
    _, tcfg, _, tl = layer
    before = (fused_mlp.fused_swiglu.launches, qkv_step.qkv_rope_step.launches)
    x = torch.randn(1, 1, 256)
    gpt._mlp_block(tl, x, tcfg)
    cos = torch.ones(1, 64)
    gpt._qkv(tl, tcfg, x, cos, cos * 0, pre_norm=(tl["norm1_w"], 1e-5))
    assert (fused_mlp.fused_swiglu.launches,
            qkv_step.qkv_rope_step.launches) == before
