"""The port's audio front end against the JAX package's, on the CPU in
float32: the resampler and Whisper log-mels (`codec/mel.py`), the SSL
tower's melspec and CQT inputs, `rvq.encode`, `scalar_ae.encode`, the wav
reader and `audio_utils`.

Inputs come from numpy with a seed; parameter trees from
`test_torch_codec._jax_params` (the JAX `init_*` traced with
`jax.eval_shape`, filled by numpy) cross through `convert_params`.

Tolerance: both sides compute in float32 (JAX matmuls at "highest",
tests/conftest.py); what differs is the order of sums (XLA vs ATen,
pocketfft vs torch's FFT) and the last bits of log / exp. Floats are held
to |port - jax| <= 1e-4 |jax| + 1e-5 max|jax| (`close`); ids must be
identical.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec import _POST_CFG, _jax_params
from uniaudio2_tpu.codec import audio_utils as jau
from uniaudio2_tpu.codec import mel as jmel
from uniaudio2_tpu.codec import rvq as jrvq
from uniaudio2_tpu.codec import scalar_ae as jsae
from uniaudio2_tpu.codec import ssl_encoder as jssl
from uniaudio2_tpu.codec import tokenizer as jtok
from uniaudio2_tpu_torch.codec import audio_utils, mel, rvq, scalar_ae, ssl_encoder
from uniaudio2_tpu_torch.codec import tokenizer
from uniaudio2_tpu_torch.convert.from_jax import convert_params

RTOL, ATOL_FRAC = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(ref).max())


def _wav(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("orig,new,t", [(24000, 16000, 7203), (16000, 24000, 4001),
                                        (44100, 24000, 3000)])
def test_resample(orig, new, t):
    wav = _wav(orig + t, (2, t))
    out = mel.resample(torch.from_numpy(wav), orig, new)
    assert out.shape == (2, -(-t * new // orig))
    close(out, jmel.resample(jnp.asarray(wav), orig, new))


def test_resample_kernel_is_jax_kernel():
    for orig, new in ((24000, 16000), (16000, 24000), (44100, 24000)):
        (k, w), (jk, jw) = mel._resample_kernel(orig, new), jmel._resample_kernel(orig, new)
        assert w == jw
        np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(mel.mel_filterbank(), jmel.mel_filterbank())


@pytest.mark.parametrize("n_mels,t", [(80, 16000), (8, 4321)])
def test_log_mel_spectrogram(n_mels, t):
    wav = _wav(n_mels, (2, t))
    wav[1] *= 0.01          # the max - 8 clamp is per batch row
    out = mel.log_mel_spectrogram(torch.from_numpy(wav), n_mels)
    assert out.shape == (2, t // mel.HOP, n_mels)
    close(out, jmel.log_mel_spectrogram(jnp.asarray(wav), n_mels))


def test_ssl_melspec_front_end():
    wav = _wav(1, (2, 8000 * 3))
    kw = dict(sample_rate=8000, label_rate=25, n_bins=24)
    out = ssl_encoder.melspec_features(torch.from_numpy(wav), **kw)
    assert out.shape == (2, 1 + wav.shape[1] // 320, 24)
    close(out, jssl.melspec_features(jnp.asarray(wav), **kw))


def test_ssl_cqt_front_end():
    wav = _wav(2, (2, 8000 * 2))
    kw = dict(sample_rate=8000, n_bins=28)
    out = ssl_encoder.cqt_features(torch.from_numpy(wav), **kw)
    assert out.shape == (2, 1 + wav.shape[1] // 160, 28)
    close(out, jssl.cqt_features(jnp.asarray(wav), **kw))


@pytest.mark.parametrize("q,lead", [(3, (2,)), (8, (2, 3))])
def test_rvq_encode(q, lead):
    jp = _jax_params(jrvq.init_params, q, dim=12, codebook_size=9, codebook_dim=4,
                     num_quantizers=q)
    x = _wav(q, lead + (7, 12), 1.0)
    idx, quant = rvq.encode(convert_params(jp, "cpu"), torch.from_numpy(x))
    jidx, jquant = jrvq.encode(jp, jnp.asarray(x))
    assert idx.dtype == torch.int32 and idx.shape == lead + (7, q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(quant, jquant)


def test_rvq_encode_tie_takes_the_first_index():
    p = {"project_in_w": torch.eye(2), "project_in_b": torch.zeros(2),
         "project_out_w": torch.eye(2), "project_out_b": torch.zeros(2),
         "codebooks": torch.tensor([[[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]])}
    idx, _ = rvq.encode(p, torch.tensor([[[0.5, 0.5]]]))
    jidx, _ = jrvq.encode({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                          jnp.asarray([[[0.5, 0.5]]]))
    assert int(idx[0, 0, 0]) == int(np.asarray(jidx)[0, 0, 0]) == 0


@pytest.mark.parametrize("name", ["tiny", "post"])
def test_scalar_ae_encode(name):
    if name == "tiny":
        jcfg, cfg = jsae.ScalarAEConfig.tiny(), scalar_ae.ScalarAEConfig.tiny()
    else:
        jcfg = jsae.ScalarAEConfig(**_POST_CFG)
        cfg = scalar_ae.ScalarAEConfig(**_POST_CFG)
    jp = _jax_params(jsae.init_params, 6, cfg=jcfg)
    wav = _wav(3, (2, 10 * cfg.total_stride + 3, 1))
    out = scalar_ae.encode(convert_params(jp, "cpu"), cfg, torch.from_numpy(wav))
    ref = jsae.encode(jp, jcfg, jnp.asarray(wav))
    assert out.shape[-1] == cfg.latent_hidden_dim
    close(out, ref)


@pytest.mark.parametrize("dtype,sr", [(np.int16, 16000), (np.float32, 24000),
                                      (np.int32, 12000)])
def test_load_wav(tmp_path, dtype, sr):
    from scipy.io import wavfile

    wav = _wav(sr, (sr // 2, 2), 0.4)
    if dtype == np.float32:
        data = wav
    else:
        data = (np.clip(wav, -0.99, 0.99) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, sr, data)
    out = tokenizer.load_wav(path, 24000)
    close(out, jtok.load_wav(path, 24000))
    tokenizer.save_wav(path, out, 24000)
    np.testing.assert_array_equal(tokenizer.load_wav(path, 24000),
                                  np.clip(out, -1.0, 1.0))


def test_audio_utils_match():
    x = np.arange(100)
    np.testing.assert_array_equal(
        audio_utils.clip_by_length(x, 30, 4, random.Random(1)),
        jau.clip_by_length(x, 30, 4, random.Random(1)))
    codes = np.random.default_rng(0).integers(0, 50, (120, 8))
    np.testing.assert_array_equal(
        audio_utils.codec_specaug(codes, -1, rng=random.Random(2)),
        jau.codec_specaug(codes, -1, rng=random.Random(2)))
    tokens = ["sil", "a_B", "b_E", "c_S", "d_B", "e_I", "f_E", "g_S"]
    phones = np.repeat(np.arange(len(tokens)), 3)
    for seed in range(4):
        assert (audio_utils.speech_edit_find_time_stamp(phones, tokens,
                                                        random.Random(seed))
                == jau.speech_edit_find_time_stamp(phones, tokens,
                                                   random.Random(seed)))
    sig = _wav(4, (24000,), 0.2)
    for s in (sig, sig[:4000], np.stack([sig, sig * 0.5])):
        assert audio_utils.loudness_lufs(s, 24000) == jau.loudness_lufs(s, 24000)
    np.testing.assert_array_equal(audio_utils.VolumeNorm(seed=3)(sig),
                                  jau.VolumeNorm(seed=3)(sig))
    np.testing.assert_array_equal(audio_utils.VolumeNorm(seed=3)(sig * 1e-4),
                                  sig * 1e-4)
