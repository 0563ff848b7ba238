"""The port's decode engine against the JAX `DecodeEngine` in every serving
weight format, on the CPU.

Configurations, as the JAX CLI spells them: A ``int8``, B ``int4`` (local
decoder, heads and projection int4, the rest int8), C ``int4allg`` (grouped
scales, row-interleaved), D ``int4all`` not interleaved (K-split +
column-packed), E ``int4allg`` not interleaved. Greedy (topk=1) decoding
must give IDENTICAL tokens: both sides run in f32, so the logits agree to
float rounding and their argmaxes agree. Each side quantizes and lays out
the same float parameters with its own entry points, and the resulting
trees must hold the same containers byte for byte.

`tiny()` is too narrow to keep a grouped leaf (its K is below 256, where
"4g" falls back to per-channel), so the model here is a one-layer, 256-wide
set of configs registered in both packages at run time. D and E are also
served with a prompt in bucket 256 (255 prefill rows, past the fused
kernels' 128), and D once from the stacked layout (``unroll=False``).

One file is one worker of a parallel run, and the JAX programs take most
of the time, so the configurations are spread over three files: this one
runs A, B and C and holds the code; `test_torch_serving_formats_ksplit.py`
(D, E) runs the same tests and `test_torch_serving_formats_layouts.py` (D
and E at bucket 256, D stacked) the tree and single-request tests, each
with its own ``served`` fixture.

Shared between cases: the float tree (one JAX init a process) and each
quantized tree (one a set of int4 modules and grouping, on either side;
D's three configurations and E's two quantize once). The port runs on one
CPU thread (`one_thread`): its tiny eager ops gain nothing from more, and
under a parallel run the threads of several workers contend (an audio
request of A read 0.13 s alone and 26 s beside one other busy process).
"""

import functools

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu import config as jconfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.ops import quant as jq

from uniaudio2_tpu_torch import config as tconfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import decode
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops import quant

INT4ALL = ("backbone", "decoder", "understanding_expert", "generation_expert",
           "audio_head", "projection_w")
INT4 = ("decoder", "audio_head", "projection_w")
# name -> (int4 modules, grouped, interleave, unroll, long prompt)
CONFIGS = {
    "A-int8": ((), False, True, True, False),
    "B-int4": (INT4, False, True, True, False),
    "C-int4allg": (INT4ALL, True, True, True, False),
    "D-int4all-ksplit": (INT4ALL, False, False, True, False),
    "E-int4allg-ksplit": (INT4ALL, True, False, True, False),
    "D-bucket256": (INT4ALL, False, False, True, True),
    "E-bucket256": (INT4ALL, True, False, True, True),
    "D-stacked": (INT4ALL, False, False, False, False),
}
FRAMES = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _configs():
    """One-layer, 256-wide configs under the same names in both packages."""
    base = dict(block_size=1024, vocab_size=1000, padded_vocab_size=1024,
                n_layer=1, n_embd=256, n_head=4, n_query_groups=2,
                intermediate_size=512, rope_base=10000.0, rope_adjustments=None)
    out = []
    for mod in (jconfig, tconfig):
        for name in ("fmt-backbone", "fmt-expert", "fmt-decoder"):
            mod.register_config(name, **base)
        out.append(dataclasses.replace(
            mod.UnifiedModelConfig.tiny(max_seq_len=1024),
            llm_name="fmt-backbone", decoder_name="fmt-decoder",
            understanding_expert_name="fmt-expert",
            generation_expert_name="fmt-expert"))
    return out


def _prompts(ts, long):
    n = 240 if long else 4                 # 240 + framing lands in bucket 256
    rng = np.random.default_rng(0)
    prompt, text = rng.integers(1, 30, n), np.array([3, 10, 2])
    tts = jtasks.prepare_tts(prompt, text, ts)
    neg = jtasks.prepare_tts_cfg_negative(prompt, text, ts)
    asr = jtasks.prepare_asr(np.array([4, 8, 9]), rng.integers(0, 30, (5, 8)),
                             rng.integers(0, 60, (n + 2, 8)), ts)
    return tts, neg, asr


@functools.lru_cache(maxsize=None)
def _float_params():
    """The JAX float tree, and its port copy."""
    params = junified.init_params(jax.random.PRNGKey(3), _configs()[0])
    return params, convert_params(params, "cpu")


@functools.lru_cache(maxsize=None)
def _quantized(modules, grouped):
    """Both packages' quantized trees of one set of int4 modules."""
    jparams, tparams = _float_params()
    return (jq.quantize_unified_params(jparams, int4_modules=modules,
                                       grouped=grouped),
            quant.quantize_unified_params(tparams, int4_modules=modules,
                                          grouped=grouped))


def _jax_serving(q, cfg, interleave, unroll):
    saved = os.environ.get("UA2_INT4I")
    os.environ["UA2_INT4I"] = "1" if interleave else "0"
    try:
        return junified.prepare_serving_params(q, dtype=jnp.float32,
                                               unroll=unroll, cfg=cfg)
    finally:
        if saved is None:
            os.environ.pop("UA2_INT4I", None)
        else:
            os.environ["UA2_INT4I"] = saved


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(ttree, jtree):
    tl, jl = dict(_leaves(ttree)), dict(_leaves(jtree))
    assert tl.keys() == jl.keys()
    for path, t in tl.items():
        j = jl[path]
        if path == "/audio_embeddings_proj":
            np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5, atol=1e-5)
        elif isinstance(t, tuple):
            assert type(t) is type(j), (path, type(t), type(j))
            assert torch.equal(t.values, j.values), path
            assert torch.equal(t.scale, j.scale), path
        else:
            assert torch.equal(t, j), path


def build(name):
    """Both engines, both trees and the prompts of configuration ``name``."""
    modules, grouped, interleave, unroll, long = CONFIGS[name]
    jcfg, tcfg = _configs()
    jquant, tquant = _quantized(modules, grouped)
    jserve = _jax_serving(jquant, jcfg, interleave, unroll)
    tserve = unified.prepare_serving_params(
        tquant, dtype=torch.float32, unroll=unroll, interleave=interleave)
    # bucket 256 gives a 512-slot cache, where "auto" picks the int8 KV
    # cache and block-128 prefix reads in both engines
    kw = dict(max_frames=FRAMES, buckets=(64, 256))
    jeng = jdecode.DecodeEngine(jserve, jcfg, cache_dtype=jnp.float32, **kw)
    teng = decode.DecodeEngine(tserve, tcfg, cache_dtype=torch.float32, **kw)
    return dict(name=name, jeng=jeng, teng=teng, jquant=jquant,
                tquant=tquant, jserve=jserve, tserve=tserve,
                prompts=_prompts(jcfg.tokens, long), long=long)


@pytest.fixture(scope="module", params=["A-int8", "B-int4", "C-int4allg"])
def served(request):
    return build(request.param)


def test_trees_container_for_container_equal(served):
    """`quantize_unified_params` and `prepare_serving_params` give the JAX
    package's trees: the same container types with the same bytes (JAX's
    chunk-major leaves un-chunked by the bridge)."""
    _assert_trees_equal(served["tquant"], convert_params(served["jquant"], "cpu"))
    _assert_trees_equal(served["tserve"], convert_params(served["jserve"], "cpu"))
    kinds = {type(v).__name__ for _, v in _leaves(served["tserve"])
             if isinstance(v, tuple)}
    want = {"A": {"QuantizedLinear"},
            "B": {"QuantizedLinear", "QuantizedLinearI4"},
            "C": {"QuantizedLinear", "QuantizedLinearI4G"},
            "D": {"QuantizedLinear", "QuantizedLinear4", "QuantizedLinearC4"},
            "E": {"QuantizedLinear", "QuantizedLinear4G",
                  "QuantizedLinearC4G"}}[served["name"][0]]
    assert kinds == want


def test_generate_audio_greedy_identical(served):
    (g, m), _, _ = served["prompts"]
    assert decode.pick_bucket(g.shape[0], (64, 256)) == \
        (256 if served["long"] else 64)
    jr, js = served["jeng"].generate_audio(g, m, topk=1)
    tr, tsem = served["teng"].generate_audio(g, m, topk=1)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tsem, js)
    assert served["teng"].last_steps == FRAMES
    policy = served["teng"].last_policy
    assert (policy["kv_dtype"], policy["attn_block"]) == (
        (torch.int8, 128) if served["long"] else (torch.float32, 0))


def test_generate_audio_cfg_greedy_identical(served):
    (g, m), (ng, nm), _ = served["prompts"]
    kw = dict(topk=1, use_cfg=True, cfg_scale=1.5, neg_grid=ng, neg_mask=nm)
    jr, js = served["jeng"].generate_audio(g, m, **kw)
    tr, tsem = served["teng"].generate_audio(g, m, **kw)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tsem, js)


def test_generate_text_greedy_identical(served):
    _, _, (g, m) = served["prompts"]
    np.testing.assert_array_equal(
        served["teng"].generate_text(g, m, topk=1),
        served["jeng"].generate_text(g, m, topk=1))
