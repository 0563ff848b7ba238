"""The port's encode towers against the JAX package's, on the CPU in float32
on the `tiny_test()` configurations: the Whisper encoder, WavLM (every
hidden state and the phone features), the BEST-RQ / MERT SSL tower in each
front end and norm order its config can select, and the reasoning branch
(CLS transformer + RVQ). The JAX side runs jitted (`jitted`), one
compile a configuration.

Tolerance as in `test_torch_audio_front.py` (`close`: 1e-4 relative plus
1e-5 x max|ref|; float32 both sides, sums in another order); ids
identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_audio_front import _wav, close
from test_torch_codec import _jax_params
from uniaudio2_tpu.codec import reasoning as jreas
from uniaudio2_tpu.codec import ssl_encoder as jssl
from uniaudio2_tpu.codec import wavlm_encoder as jwavlm
from uniaudio2_tpu.codec import whisper_encoder as jwhisper
from uniaudio2_tpu_torch.codec import reasoning, ssl_encoder, wavlm_encoder
from uniaudio2_tpu_torch.codec import whisper_encoder
from uniaudio2_tpu_torch.convert.from_jax import convert_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(jmod, mod, cfg_kwargs, seed, factory="tiny_test"):
    """(JAX config, JAX params, port config, port params)."""
    jcfg = (getattr(jmod, _CONFIG[jmod])(**cfg_kwargs) if factory is None
            else getattr(getattr(jmod, _CONFIG[jmod]), factory)())
    cfg = getattr(mod, _CONFIG[jmod])(**jcfg.__dict__)
    jp = _jax_params(jmod.init_params, seed, cfg=jcfg)
    return jcfg, jp, cfg, convert_params(jp, "cpu")


def jitted(fn, **static):
    return jax.jit(functools.partial(fn, **static))


_CONFIG = {jwhisper: "WhisperEncoderConfig", jwavlm: "WavLMConfig",
           jssl: "SSLEncoderConfig", jreas: "ReasoningConfig"}


def test_whisper_forward():
    jcfg, jp, cfg, tp = _pair(jwhisper, whisper_encoder, {}, 0)
    mels = _wav(0, (2, 101, cfg.n_mels), 1.0)
    out = whisper_encoder.forward(tp, cfg, torch.from_numpy(mels))
    assert out.shape == (2, 51, cfg.d_model)
    close(out, jitted(jwhisper.forward, cfg=jcfg)(jp, mels=jnp.asarray(mels)))


def test_wavlm_forward_and_phone_features():
    jcfg, jp, cfg, tp = _pair(jwavlm, wavlm_encoder, {}, 1)
    wav = _wav(1, (2, 1701))
    hs = wavlm_encoder.forward(tp, cfg, torch.from_numpy(wav))
    jhs = jitted(jwavlm.forward, cfg=jcfg)(jp, wav=jnp.asarray(wav))
    assert len(hs) == cfg.num_layers + 1
    for a, b in zip(hs, jhs):
        close(a, b)
    close(wavlm_encoder.phone_features(tp, cfg, torch.from_numpy(wav)),
          jitted(jwavlm.phone_features, cfg=jcfg)(jp, wav=jnp.asarray(wav)))


@pytest.mark.parametrize("t", [7, 60, 130])
def test_relative_position_buckets(t):
    for nb, md in ((32, 50), (320, 800)):
        np.testing.assert_array_equal(
            wavlm_encoder.relative_position_buckets(t, nb, md),
            jwavlm._relative_position_buckets(t, nb, md))


_SSL = {
    "post-norm": {},
    "pre-norm": dict(layer_norm_first=True, wav_normalize=True, conv_bias=True,
                     stable_post_proj_ln=True, extractor_mode="layer_norm"),
    "melspec": dict(frontend="melspec", sample_rate=8000, label_rate=50,
                    melspec_n_bins=24),
    "cqt": dict(conv_kernel=(10, 4, 8), conv_stride=(5, 4, 8), sample_rate=8000,
                cqt_bins=28),
}


@pytest.mark.parametrize("variant", list(_SSL))
def test_ssl_forward(variant):
    base = jssl.SSLEncoderConfig.tiny_test().__dict__
    jcfg, jp, cfg, tp = _pair(jssl, ssl_encoder, {**base, **_SSL[variant]}, 2,
                              factory=None)
    wav = _wav(2, (2, 3200))
    final, outs = ssl_encoder.forward(tp, cfg, torch.from_numpy(wav))
    jfinal, jouts = jitted(jssl.forward, cfg=jcfg)(jp, wav=jnp.asarray(wav))
    close(final, jfinal)
    assert len(outs) == len(jouts) == cfg.num_layers
    for a, b in zip(outs, jouts):
        close(a, b)
    ac, sem = ssl_encoder.acoustic_semantic_features(tp, cfg, torch.from_numpy(wav),
                                                     layers=(1, 0))
    close(ac, jouts[1])
    close(sem, jouts[0])


def test_ssl_config_refuses_what_it_cannot_build():
    for bad in (dict(frontend="hstft_conv"), dict(frontend="melspec", cqt_bins=28)):
        with pytest.raises(ValueError):
            ssl_encoder.init_params(torch.Generator(), ssl_encoder.SSLEncoderConfig(**bad),
                                    device="cpu")


def test_cls_interleave_and_extract():
    x = _wav(3, (2, 10, 3), 1.0)
    cls = _wav(4, (3,), 1.0)
    out = reasoning.interleave_cls(torch.from_numpy(x), torch.from_numpy(cls), 5)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jreas.interleave_cls(jnp.asarray(x), jnp.asarray(cls), 5)))
    np.testing.assert_array_equal(reasoning.extract_cls(out, 5).numpy(),
                                  np.broadcast_to(cls, (2, 2, 3)))


def test_partial_rope():
    cos, sin = reasoning.rope_tables(37, 8, "cpu")
    jcos, jsin = jreas._rope_tables(37, 8)
    close(cos, jcos)
    close(sin, jsin)
    x = _wav(5, (2, 3, 37, 16), 1.0)
    close(reasoning.apply_partial_rope(torch.from_numpy(x), cos, sin, 8),
          jreas._apply_partial_rope(jnp.asarray(x), jcos, jsin, 8))


@pytest.mark.parametrize("t50,t25", [(40, 20), (47, 26)])
def test_reasoning_encode(t50, t25):
    jcfg, jp, cfg, tp = _pair(jreas, reasoning, {}, 3)
    w = _wav(t50, (2, t50, cfg.whisper_dim), 1.0)
    b = _wav(t25, (2, t25, cfg.bestrq_dim), 1.0)
    codes, quant = reasoning.encode(tp, cfg, torch.from_numpy(w), torch.from_numpy(b))
    jcodes, jquant = jitted(jreas.encode, cfg=jcfg)(jp, whisper_feats=jnp.asarray(w),
                                                    bestrq_semantic=jnp.asarray(b))
    assert codes.shape == (2, 4, cfg.num_quantizers)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    close(quant, jquant)
