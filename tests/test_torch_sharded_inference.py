"""The port's sharded inference (`parallel/mesh.py`, `DecodeEngine(mesh=,
use_tp=)`, `gpt.forward(tp=)`), the counterpart of each case of
`tests/test_sharded_inference.py`, against the JAX package's unsharded
outputs on the same parameters.

The sharded cases run once, on eight CPU ranks in a gloo group forming
JAX's (fsdp=4, tp=2) mesh (`parallel.dryrun.inference_main`, spawned by a
module fixture, joined under a deadline); the tests read what rank 0 wrote.

Tolerances: greedy tokens identical (the engines, float and int8 KV; the
decode frame) and the frame's backbone K rows within TOL; `forward_text`'s
logits within TOL (`tests/test_torch_models.py`'s); the MoE loss within
LOSS_RTOL and each gradient within GRAD_TOL x max|grad| of the leaf
(`tests/test_torch_train.py`'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uniaudio2_tpu.config import GPTConfig as JGPTConfig
from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.engine.decode import DecodeEngine as JEngine
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.parallel import mesh as jmesh

from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.parallel import dryrun, mesh as meshlib

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4

# expert stacks of 2^18 elements: the fsdp rule shards them (>= 2^16)
MOE = dict(name="tiny-moe", block_size=64, vocab_size=96, padding_multiple=8,
           n_layer=2, n_embd=128, n_head=4, n_query_groups=2,
           intermediate_size=256, rope_adjustments=None, n_expert=4,
           n_expert_per_token=2, moe_intermediate_size=256)


def _norm(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + (f,))
    else:
        yield path, tree


def _jax_get(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else (
            getattr(tree, p) if hasattr(tree, "_fields") else tree[p])
    return tree


def _jax_side(jp, jcfg, moe_params, x):
    """Every expected value, from the JAX package, unsharded."""
    out = {}
    caches = junified.init_caches(jcfg, 1, dtype=jnp.float32)
    frame, caches2 = junified.decode_frame(
        jp, jcfg, jnp.zeros((1, 1, 9), jnp.int32), jnp.ones((1, 1, 9), bool),
        caches, jnp.int32(0), jax.random.PRNGKey(1), temperature=0.9, topk=1,
        forbid_prefix=jnp.int32(0))
    out["frame"] = np.asarray(frame)
    out["k0"] = np.asarray(caches2.backbone.k[:, :, :, :1])
    toks = np.random.default_rng(3).integers(0, 30, (2, 6, 9))
    out["forward_text"] = np.asarray(junified.forward_text(
        jp, jcfg, jnp.asarray(toks), jnp.ones((2, 6, 9), bool)))
    g, m = jtasks.prepare_tts(np.array([1, 5, 6]), np.array([1, 10, 2]),
                              jcfg.tokens)
    for key, kw in (("engine", {}), ("engine_int8", {"kv_quant": "on"})):
        eng = JEngine(jp, jcfg, max_frames=6, cache_dtype=jnp.float32,
                      buckets=(32,), **kw)
        out[key] = {"text": np.asarray(eng.generate_text(g, m, topk=1))}
        if not kw:
            out[key]["audio"] = [np.asarray(a) for a in
                                 eng.generate_audio(g, m, topk=1)[:2]]
    mcfg = JGPTConfig(**MOE)

    def loss_fn(p):
        h = jgpt.forward(p, mcfg, jgpt.embed(p, x))
        return jnp.mean(jgpt.lm_head(p, h, mcfg) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(moe_params)
    out["moe_loss"] = float(loss)
    out["moe_grads"] = [np.asarray(grads["layers"]["fc1_w"]),
                        np.asarray(grads["layers"]["moe_gate_w"]),
                        np.asarray(grads["wte"])]
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(0), jcfg)
    mp = jgpt.init_params(jax.random.PRNGKey(0), JGPTConfig(**MOE))
    x = jnp.asarray(np.random.default_rng(4).integers(0, 96, (2, 6)))
    torch.save(convert_params(jp, "cpu"), d / "params.pt")
    torch.save({"cfg": MOE, "params": convert_params(mp, "cpu"),
                "x": torch.from_numpy(np.array(x)).long()}, d / "moe.pt")
    dryrun.spawn(dryrun.inference_main, 8, str(d / "params.pt"),
                 str(d / "moe.pt"), str(d / "out.pt"), timeout_s=240)
    return (torch.load(d / "out.pt", weights_only=False),
            _jax_side(jp, jcfg, mp, x))


def test_sharded_decode_frame(sharded):
    """A decode frame with the parameters placed by the spec rules on
    (fsdp=4, tp=2) and the caches holding each rank's kv groups: JAX's
    greedy frame and backbone K rows; `forward_text` on the mesh (tensor
    parallel): JAX's logits."""
    got, want = sharded
    np.testing.assert_array_equal(got["frame"].numpy(), want["frame"])
    np.testing.assert_allclose(got["k0"].numpy(), want["k0"], **TOL)
    assert got["forward_text"].shape == (2, 6, 1024)
    np.testing.assert_allclose(got["forward_text"].numpy(),
                               want["forward_text"], **TOL)


def test_sharded_moe_forward(sharded):
    """Expert-parallel MoE: expert stacks sharded (E over tp, in-dim over
    fsdp), each tp rank running its experts, forward + grad: JAX's loss
    and gradients; the gradients come back placed as their leaves."""
    got, want = sharded
    np.testing.assert_allclose(float(got["moe_loss"]), want["moe_loss"],
                               rtol=LOSS_RTOL)
    for g, j in zip(got["moe_grads"], want["moe_grads"]):
        assert tuple(g.shape) == j.shape
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max())
    for grad_places, leaf_places in got["moe_placements"]:
        assert grad_places == leaf_places
    # fc1_w (L, E, D, I): experts over tp, D over fsdp
    assert got["moe_placements"][0][1] == \
        "(Replicate(), Shard(dim=2), Shard(dim=1))"


def test_mesh_serving_engine_matches_single_device(sharded):
    """`DecodeEngine(mesh=, use_tp=True)` on (fsdp=4, tp=2): JAX's greedy
    text and audio, and the batched rows its text."""
    got, want = sharded
    np.testing.assert_array_equal(got["engine"]["text"],
                                  want["engine"]["text"])
    for a, b in zip(got["engine"]["audio"], want["engine"]["audio"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["engine"]["batch"]) == 3
    for row in got["engine"]["batch"]:
        np.testing.assert_array_equal(row, want["engine"]["text"])


def test_mesh_serving_int8_kv_matches_single_device(sharded):
    """The int8 KV cache under tp (values and per-slot scales both hold the
    rank's kv groups): JAX's unsharded int8 greedy stream, batched too."""
    got, want = sharded
    np.testing.assert_array_equal(got["engine_int8"]["text"],
                                  want["engine_int8"]["text"])
    for row in got["engine_int8"]["batch"]:
        np.testing.assert_array_equal(row, want["engine_int8"]["text"])


def test_param_specs_fire_for_quantized_serving_layout():
    """The port's counterpart of JAX's quantized-layout case: the rules key
    on the enclosing weight name; values split, scales replicated, and
    JAX's spec tree equals the port's on the same layout."""
    from uniaudio2_tpu.ops import quant as jquant
    from uniaudio2_tpu_torch.ops import quant

    def tree(mod, zeros, ones):
        q = lambda k, n: mod.QuantizedLinear4(  # noqa: E731
            zeros((k // 2, n), "int8"), zeros((n,), "float32"))
        qc = lambda k, n: mod.QuantizedLinearC4(  # noqa: E731
            zeros((k, n // 2), "int8"), zeros((n,), "float32"))
        return {"backbone": {"layers": [{
            "qkv_w": q(1024, 1280), "attn_proj_w": q(1024, 1024),
            "fc1_w": q(1024, 2048), "fc2_w": q(1024, 2048),
            "mlp_proj_w": qc(2048, 1024), "norm1_w": ones((1024,))}],
            "lm_head_w": q(1024, 4096)},
            "audio_head": [qc(1024, 4096)]}

    jt = tree(jquant, lambda s, d: jnp.zeros(s, d), jnp.ones)
    tt = tree(quant, lambda s, d: torch.zeros(s, dtype=getattr(torch, d)),
              torch.ones)
    specs = meshlib.unified_param_specs(tt, use_tp=True)
    layer = specs["backbone"]["layers"][0]
    assert layer["qkv_w"].values == ("fsdp", "tp")       # column-parallel
    assert layer["qkv_w"].scale == ()                    # replicated
    assert layer["mlp_proj_w"].values == ("tp", "fsdp")  # row-parallel
    assert layer["norm1_w"] == ()
    assert specs["audio_head"][0].values == ("fsdp", "tp")
    jspecs = jmesh.unified_param_specs(jt, use_tp=True)
    for path, spec in _leaves_with_path(specs):
        assert spec == _norm(_jax_get(jspecs, path)), path
    # a packed dimension that the mesh does not divide falls back to whole
    fitted = meshlib.fit_specs_to_mesh(specs, tt, {"replica": 1, "fsdp": 3,
                                                   "tp": 2})
    assert fitted["backbone"]["layers"][0]["mlp_proj_w"].values == ("tp",)


def test_fit_spec_to_mesh_indivisible_dims():
    """JAX's `test_fit_spec_to_mesh_indivisible_dims` on the port."""
    m = {"replica": 1, "fsdp": 8, "tp": 1}
    assert meshlib.fit_spec_to_mesh(("fsdp",), (28, 3072), m) == ()
    assert meshlib.fit_spec_to_mesh((None, "fsdp"), (28, 3072), m) \
        == (None, "fsdp")
    assert meshlib.fit_spec_to_mesh(("fsdp", "tp"), (64, 3072), m) \
        == ("fsdp", "tp")
    m2 = {"replica": 2, "fsdp": 4, "tp": 1}
    assert meshlib.fit_spec_to_mesh((("replica", "fsdp"),), (24,), m2) \
        == (("replica", "fsdp"),)
    assert meshlib.fit_spec_to_mesh((("replica", "fsdp"),), (28,), m2) == ()
    jm = jmesh.build_mesh(replica=1, fsdp=8, tp=1)
    for spec, shape in (((None, "fsdp"), (28, 3072)), (("fsdp",), (28, 64)),
                        ((("replica", "fsdp"),), (24,))):
        assert meshlib.fit_spec_to_mesh(spec, shape, m) == _norm(
            jmesh.fit_spec_to_mesh(P(*spec), shape, jm))


