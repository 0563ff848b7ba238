"""The port's encode path as a whole against the JAX package's, on the CPU
in float32 on `EncoderConfig.tiny_test()`: `fuse_and_quantize`,
`encode_window` at a 16 kHz and a 24 kHz codec rate, `tokenize` of a clip
that needs three windows at ``batch_size=2`` (so the tail batch is padded)
from an array and from a wav file, and the tiny ASR chain wav ->
`tokenize` -> `prepare_asr` -> `generate_text` (greedy) against the JAX
`DecodeEngine` on `UnifiedModelConfig.tiny()`.

Ids must be identical everywhere. The JAX encode runs jitted through the
JAX tokenizer, one compiled shape per codec rate (the JAX facade pads the
tail batch to that shape), and one compiled JAX engine serves the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_audio_front import _wav
from test_torch_codec import _jax_params
from uniaudio2_tpu.codec import decoder as jdecoder
from uniaudio2_tpu.codec import encoder as jenc
from uniaudio2_tpu.codec import tokenizer as jtok
from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu_torch.codec import decoder, encoder, tokenizer
from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import decode, tasks

MIN_DURATION = 0.5          # a window of 0.5 s + the 240-sample guard
TASK_PROMPT = np.array([4, 8, 9])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _codec_kwargs(sr):
    return dict(sample_rate=sr, codec_dim=16, latent_dim=8, rec_codebook_size=32,
                reason_codebook_size=16, rec_codebook_dim=8, reason_codebook_dim=8,
                window_seconds=0.5)


@pytest.fixture(scope="module")
def tree():
    jcfg = jenc.EncoderConfig.tiny_test()
    jp = _jax_params(jenc.init_encode_params, 0, cfg=jcfg)
    return jcfg, jp, encoder.EncoderConfig.tiny_test(), convert_params(jp, "cpu")


@pytest.fixture(scope="module", params=[16000, 24000])
def tokenizers(request, tree):
    """(JAX tokenizer, port tokenizer) at one codec rate."""
    jcfg, jp, cfg, tp = tree
    sr = request.param
    jt = jtok.ReasoningCodecTokenizer(jp, None, jcfg,
                                      jdecoder.CodecConfig(**_codec_kwargs(sr)),
                                      min_duration=MIN_DURATION)
    tt = tokenizer.ReasoningCodecTokenizer(tp, None, cfg,
                                           decoder.CodecConfig(**_codec_kwargs(sr)),
                                           min_duration=MIN_DURATION)
    return jt, tt


def test_fuse_and_quantize(tree):
    jcfg, jp, cfg, tp = tree
    rng = np.random.default_rng(1)
    b = 2
    feats = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, 41, cfg.whisper.d_model), (b, 43, cfg.wavlm_dim),
        (b, 21, cfg.bestrq_dim), (b, 22, cfg.bestrq_dim), (b, 4, cfg.codec_dim))]
    out = encoder.fuse_and_quantize(tp, *map(torch.from_numpy, feats))
    ref = np.asarray(jenc.fuse_and_quantize(jp, *map(jnp.asarray, feats)))
    assert out.shape == ref.shape == (b, 10, 8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_film(tree):
    x, cond = _wav(2, (2, 9, 4), 1.0), _wav(3, (2, 7, 4), 1.0)
    layer = {"w": _wav(4, (4, 8), 1.0), "b": _wav(5, (8,), 1.0)}
    out = encoder.film(torch.from_numpy(x), torch.from_numpy(cond),
                       {k: torch.from_numpy(v) for k, v in layer.items()})
    ref = jenc.film(jnp.asarray(x), jnp.asarray(cond),
                    {k: jnp.asarray(v) for k, v in layer.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_encode_window(tokenizers):
    jt, tt = tokenizers
    win = int(MIN_DURATION * tt.cfg.sample_rate) + tt.GUARD_SAMPLES
    wav = _wav(tt.cfg.sample_rate, (2, win))
    jreason, jrec = jt._window_encode(wav)
    reason, rec = tt._window_encode(wav)
    assert reason.shape[-1] == rec.shape[-1] == 8 and reason.shape[1] > 0
    np.testing.assert_array_equal(reason, jreason)
    np.testing.assert_array_equal(rec, jrec)


def _clip(sr):
    """A clip that needs three windows: 2.5 windows long."""
    return _wav(7, (int(2.5 * MIN_DURATION * sr),))


def test_tokenize_three_windows_padded_tail(tokenizers):
    jt, tt = tokenizers
    sr = tt.cfg.sample_rate
    clip = _clip(sr)
    win = int(MIN_DURATION * sr) + tt.GUARD_SAMPLES
    assert len(clip) // (win - tt.GUARD_SAMPLES) + 1 == 3   # three windows, B = 2
    reason, rec = tt.tokenize(clip, batch_size=2)
    jreason, jrec = jt.tokenize(clip, batch_size=2)
    assert reason.shape[0] == rec.shape[0] == 8 and reason.dtype == np.int64
    np.testing.assert_array_equal(reason, jreason)
    np.testing.assert_array_equal(rec, jrec)
    # the padded tail batch changes no token of the unpadded encode
    r1, c1 = tt.tokenize(clip, batch_size=3)
    np.testing.assert_array_equal(r1, reason)
    np.testing.assert_array_equal(c1, rec)


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxConfig.tiny()
    params = junified.init_params(jax.random.PRNGKey(3), jcfg)
    jeng = jdecode.DecodeEngine(params, jcfg, max_frames=8, cache_dtype=jnp.float32,
                                buckets=(64,))
    teng = decode.DecodeEngine(convert_params(params, "cpu"), UnifiedModelConfig.tiny(),
                               max_frames=8, cache_dtype=torch.float32, buckets=(64,))
    return jeng, teng


def test_asr_from_a_wav_file(tmp_path, tokenizers, engines):
    """wav file -> tokens -> ASR grid -> greedy text, both packages."""
    jt, tt = tokenizers
    jeng, teng = engines
    sr = tt.cfg.sample_rate
    path = str(tmp_path / "clip.wav")
    tokenizer.save_wav(path, _wav(8, (int(0.8 * sr),)), sr)
    reason, semantic = tt.tokenize(path)
    jreason, jsemantic = jt.tokenize(path)
    np.testing.assert_array_equal(reason, jreason)
    np.testing.assert_array_equal(semantic, jsemantic)
    g, m = tasks.prepare_asr(TASK_PROMPT, reason.T, semantic.T,
                             UnifiedModelConfig.tiny().tokens)
    jg, jm = jtasks.prepare_asr(TASK_PROMPT, jreason.T, jsemantic.T,
                                JaxConfig.tiny().tokens)
    np.testing.assert_array_equal(g, jg)
    text = teng.generate_text(g, m, topk=1)
    np.testing.assert_array_equal(text, jeng.generate_text(jg, jm, topk=1))
    assert text.size > 0
