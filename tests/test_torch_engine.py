"""The port's decode engine against the JAX `DecodeEngine` on `tiny()`.

Greedy (topk=1) decoding must give IDENTICAL tokens: both sides run in f32
(conftest sets JAX's matmul precision to "highest"), so the logits agree to
float rounding and their argmaxes agree. Sampled paths cannot be compared
token for token (the two frameworks' random streams differ). Parameters
come from the JAX package and cross through `convert/from_jax.py`, with
float weights and with int4all serving weights (quantized, interleaved and
chunk-major on the JAX side, un-chunked by the bridge).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.ops.quant import quantize_unified_params as jax_quantize

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import decode, tasks

INT4ALL = ("backbone", "decoder", "understanding_expert", "generation_expert",
           "audio_head", "projection_w")
FRAMES = 8


def _prompts(ts):
    tts = jtasks.prepare_tts(np.array([1, 5, 6, 7]), np.array([3, 10, 2]), ts)
    neg = jtasks.prepare_tts_cfg_negative(np.array([1, 5, 6, 7]),
                                          np.array([3, 10, 2]), ts)
    rng = np.random.default_rng(0)
    asr = jtasks.prepare_asr(np.array([4, 8, 9]), rng.integers(0, 30, (5, 8)),
                             rng.integers(0, 60, (6, 8)), ts)
    return tts, neg, asr


@pytest.fixture(scope="module", params=["float", "int4all"])
def engines(request):
    jcfg = JaxConfig.tiny()
    params = junified.init_params(jax.random.PRNGKey(3), jcfg)
    if request.param == "int4all":
        params = jax_quantize(params, int4_modules=INT4ALL)
        params = junified.prepare_serving_params(params, dtype=jnp.float32,
                                                 cfg=jcfg)
    jeng = jdecode.DecodeEngine(params, jcfg, max_frames=FRAMES,
                                cache_dtype=jnp.float32, buckets=(64,))
    teng = decode.DecodeEngine(convert_params(params, "cpu"),
                               UnifiedModelConfig.tiny(), max_frames=FRAMES,
                               cache_dtype=torch.float32, buckets=(64,))
    return jeng, teng, _prompts(jcfg.tokens)


def test_generate_audio_greedy_identical(engines):
    jeng, teng, ((g, m), _, _) = engines
    jr, js = jeng.generate_audio(g, m, topk=1)
    tr, tsem = teng.generate_audio(g, m, topk=1)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tsem, js)
    assert tr.shape[0] == 8 and teng.last_steps == FRAMES


def test_generate_audio_cfg_greedy_identical(engines):
    jeng, teng, ((g, m), (ng, nm), _) = engines
    kw = dict(topk=1, use_cfg=True, cfg_scale=1.5, neg_grid=ng, neg_mask=nm)
    jr, js = jeng.generate_audio(g, m, **kw)
    tr, tsem = teng.generate_audio(g, m, **kw)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tsem, js)


def test_generate_text_greedy_identical(engines):
    jeng, teng, (_, _, (g, m)) = engines
    np.testing.assert_array_equal(teng.generate_text(g, m, topk=1),
                                  jeng.generate_text(g, m, topk=1))


def test_sampled_decode_runs_and_is_seeded(engines):
    """Sampled tokens cannot match JAX; the port's must be valid ids and
    reproducible from the seed."""
    _, teng, ((g, m), _, _) = engines
    a = teng.generate_audio(g, m, topk=5, temperature=0.9, seed=7)
    b = teng.generate_audio(g, m, topk=5, temperature=0.9, seed=7)
    np.testing.assert_array_equal(a[0], b[0])
    vocab = UnifiedModelConfig.tiny().tokens.audio_vocab
    assert a[0].size and a[0].min() >= 0 and a[0].max() < vocab


@pytest.mark.parametrize("task", ["tts", "tts_neg", "asr"])
def test_task_grids_equal(task):
    ts = JaxConfig.tiny().tokens
    pts = UnifiedModelConfig.tiny().tokens
    rng = np.random.default_rng(1)
    prompt, text = rng.integers(0, 30, 6), rng.integers(0, 30, 4)
    reason, sem = rng.integers(0, 30, (3, 8)), rng.integers(0, 60, (4, 8))
    fns = {"tts": ("prepare_tts", (prompt, text)),
           "tts_neg": ("prepare_tts_cfg_negative", (prompt, text)),
           "asr": ("prepare_asr", (prompt, reason, sem))}
    name, args = fns[task]
    jg, jm = getattr(jtasks, name)(*args, ts)
    tg, tm = getattr(tasks, name)(*args, pts)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tm, jm)


def test_split_two_phase_equal():
    rng = np.random.default_rng(2)
    audio = rng.integers(0, 100, (12, 8))
    phases = rng.integers(0, 3, 12)
    for n in (0, 5, 12):
        for a, b in zip(decode.split_two_phase(audio, phases, n, 40),
                        jdecode.split_two_phase(audio, phases, n, 40)):
            np.testing.assert_array_equal(a, b)


def test_resolve_policies_equal():
    for length in (1, 64, 65, 2048):
        assert decode.pick_bucket(length) == jdecode.pick_bucket(length)
    for cache_len in (256, 511, 512, 768):
        for blk in (None, -1, 0, 64):
            assert decode.resolve_attn_block(blk, cache_len) == \
                jdecode.resolve_attn_block(blk, cache_len)
        for mode in (None, "auto", "on", "off", "1", "0", "int8"):
            for batch in (1, 2, 8):
                t = decode.resolve_kv_quant(mode, cache_len, torch.bfloat16,
                                            batch)
                j = jdecode.resolve_kv_quant(mode, cache_len, jnp.bfloat16,
                                             batch)
                assert (t == torch.int8) == (j == jnp.int8)
    for mode in (None, "inline", "deferred"):
        assert decode.resolve_kv_write(mode) == jdecode.resolve_kv_write(mode)


def test_unported_paths_raise(engines):
    """Batched, beam and n-gram decoding, which raised NotImplementedError
    until they were ported, return results of the right shapes (their
    tokens are held to JAX in `test_torch_batch_decode.py` and
    `test_torch_beam.py`); arguments they cannot serve raise."""
    _, teng, ((g, m), (ng, nm), (ag, am)) = engines
    ts = teng.cfg.tokens
    texts = teng.generate_text_batch([(ag, am), (g, m)])
    assert len(texts) == 2 and all(t.ndim == 1 and len(t) <= FRAMES
                                   for t in texts)
    audio = teng.generate_audio_batch([(g, m)], use_cfg=True, cfg_scale=1.5,
                                      neg_items=[(ng, nm)], topk=1)
    (reason, semantic), = audio
    assert reason.shape[0] == semantic.shape[0] == ts.num_codebooks
    assert reason.shape[1] + semantic.shape[1] <= FRAMES
    beam = teng.generate_text_beam(ag, am, beam_size=2, max_steps=3)
    assert beam.ndim == 1 and len(beam) <= 3
    blocked = teng.generate_text(ag, am, no_repeat_ngram=3)
    assert blocked.ndim == 1 and len(blocked) <= FRAMES
    with pytest.raises(ValueError):
        teng.generate_text_batch([(g, m)], seeds=[1, 2])
    with pytest.raises(ValueError):
        teng.generate_audio_batch([(g, m)], use_cfg=True)


def test_port_imports_no_jax():
    code = ("import sys, uniaudio2_tpu_torch.engine.decode, "
            "uniaudio2_tpu_torch.convert.from_jax, "
            "uniaudio2_tpu_torch.ops.fused_mlp, uniaudio2_tpu_torch.ops.qkv_step, "
            "uniaudio2_tpu_torch.ops.flash_attention, "
            "uniaudio2_tpu_torch.codec.decoder, "
            "uniaudio2_tpu_torch.codec.streaming_decoder, "
            "uniaudio2_tpu_torch.probes.int4_native_probe, "
            "uniaudio2_tpu_torch.probes.sweep_gemv_blocks, "
            "uniaudio2_tpu_torch.probes.profile_scan_slice, "
            "uniaudio2_tpu_torch.ops.int4_stacked;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'uniaudio2_tpu')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
