"""Codec encode path: waveform -> (reasoning codes, reconstruction codes)
(port of `uniaudio2_tpu/codec/encoder.py`).

towers (frozen):  whisper encoder @50 Hz · WavLM layers-6..9 mean @50 Hz ·
                  BEST-RQ/MERT layers 4/11 @25 Hz
reasoning branch: whisper/2 ‖ BEST-RQ semantic -> CLS-query transformer ->
                  RVQ 8 x 4096 @5 Hz (`reasoning.py`)
rec branches:     stride-4/4/2/2 downsample convs to 12.5 Hz, per-branch
                  condition-fusion linears, FiLM from the (x2.5-upsampled)
                  quantized reasoning features, three RVQs (phone 1 ‖
                  structure 1 ‖ acoustic 6) -> 8 codebooks @12.5 Hz

Every length is set, as in the JAX function, by truncating to the shortest
branch: the Whisper mels cut to 2 max_positions, 160 zero samples appended
before WavLM, the 2 len_sem cuts, the min-length concatenations. FiLM is
deterministic (no inference-time condition dropout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from uniaudio2_tpu_torch.codec import mel, reasoning, rvq, ssl_encoder
from uniaudio2_tpu_torch.codec import wavlm_encoder, whisper_encoder
from uniaudio2_tpu_torch.codec.decoder import CodecConfig, _upsample_nearest
from uniaudio2_tpu_torch.codec.layers import conv, normal
from uniaudio2_tpu_torch.codec.reasoning import ReasoningConfig
from uniaudio2_tpu_torch.codec.ssl_encoder import SSLEncoderConfig
from uniaudio2_tpu_torch.codec.wavlm_encoder import WavLMConfig
from uniaudio2_tpu_torch.codec.whisper_encoder import WhisperEncoderConfig

Params = Dict[str, Any]


@dataclass(frozen=True)
class EncoderConfig:
    whisper: WhisperEncoderConfig = WhisperEncoderConfig.medium()
    wavlm: WavLMConfig = WavLMConfig.base()
    ssl: SSLEncoderConfig = SSLEncoderConfig()
    reasoning: ReasoningConfig = ReasoningConfig()
    codec_dim: int = 768
    wavlm_dim: int = 768
    bestrq_dim: int = 1024
    # BEST-RQ layer indices used as (acoustic, semantic) features
    ssl_layers: Tuple[int, int] = (4, 11)

    @classmethod
    def tiny_test(cls) -> "EncoderConfig":
        return cls(
            whisper=WhisperEncoderConfig(n_mels=8, d_model=24, n_layers=1,
                                         n_heads=2, ffn_dim=32,
                                         max_positions=512),
            wavlm=WavLMConfig.tiny_test(),          # hidden 32
            ssl=SSLEncoderConfig.tiny_test(),       # hidden 32
            reasoning=ReasoningConfig(dim=16, head_dim=8, depth=1,
                                      whisper_dim=24, bestrq_dim=32,
                                      rope_dim=4, codebook_size=16,
                                      codebook_dim=8, num_quantizers=8),
            codec_dim=16, wavlm_dim=32, bestrq_dim=32,
            ssl_layers=(0, 1),
        )


def init_encode_params(generator: torch.Generator, cfg: EncoderConfig,
                       dtype=torch.float32, device="cuda") -> Params:
    d = cfg.codec_dim

    def lin(cin, cout):
        return {"w": normal(generator, (cin, cout), 0.02, dtype, device),
                "b": torch.zeros((cout,), dtype=dtype, device=device)}

    def down(k, c):
        s = (1.0 / (c * k)) ** 0.5
        u = torch.rand((k, c, c), generator=generator, device=device,
                       dtype=torch.float32)
        return {"w": ((u * 2.0 - 1.0) * s).to(dtype),
                "b": torch.zeros((c,), dtype=dtype, device=device)}

    def codebook(q):
        full = d == 768
        return rvq.init_params(generator, dim=d,
                               codebook_size=8192 if full else 32,
                               codebook_dim=32 if full else 8, num_quantizers=q,
                               dtype=dtype, device=device)

    kw = dict(dtype=dtype, device=device)
    return {
        "whisper": whisper_encoder.init_params(generator, cfg.whisper, **kw),
        "wavlm": wavlm_encoder.init_params(generator, cfg.wavlm, **kw),
        "ssl": ssl_encoder.init_params(generator, cfg.ssl, **kw),
        "reasoning": reasoning.init_params(generator, cfg.reasoning, **kw),
        "d_conv_whisper": down(4, cfg.whisper.d_model),
        "d_conv_wavlm": down(4, cfg.wavlm_dim),
        "d_conv_semantic": down(2, cfg.bestrq_dim),
        "d_conv_acoustic": down(2, cfg.bestrq_dim),
        "fusion_phone": lin(cfg.wavlm_dim, d),
        "fusion_semantic": lin(cfg.bestrq_dim, d),
        "fusion_acoustic": lin(cfg.bestrq_dim + cfg.whisper.d_model, d),
        "film_phone": lin(d, 2 * d),
        "film_semantic": lin(d, 2 * d),
        "film_acoustic": lin(d, 2 * d),
        "rvq_phone": codebook(1),
        "rvq_semantic": codebook(1),
        "rvq_acoustic": codebook(6),
        "reason_adaptor": lin(d, d),
    }


def _dconv(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """VALID strided downsample conv, (B, T, C)."""
    return (conv(x, p["w"], stride=stride) + p["b"]).to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def film(x: torch.Tensor, cond: torch.Tensor, layer: Params, *,
         gamma_scale: float = 0.1) -> torch.Tensor:
    """FiLM modulation, both inputs cut to the shorter length."""
    tl = min(x.shape[1], cond.shape[1])
    x, cond = x[:, :tl], cond[:, :tl]
    delta_gamma, beta = _linear(cond, layer).chunk(2, -1)
    return (1.0 + gamma_scale * torch.tanh(delta_gamma)) * x + beta


def fuse_and_quantize(params: Params, whisper_f: torch.Tensor, wavlm_f: torch.Tensor,
                      bestrq_ac: torch.Tensor, bestrq_sem: torch.Tensor,
                      reason_q: torch.Tensor) -> torch.Tensor:
    """Tower features (50 Hz whisper and WavLM, 25 Hz BEST-RQ) + quantized
    reasoning (5 Hz) -> rec codes (B, T12.5, 8) int32."""
    rf = _upsample_nearest(_linear(reason_q, params["reason_adaptor"]), 2.5)

    whisper_ds = _dconv(whisper_f, params["d_conv_whisper"], 4)
    wavlm_ds = _dconv(wavlm_f, params["d_conv_wavlm"], 4)
    sem_ds = _dconv(bestrq_sem, params["d_conv_semantic"], 2)
    ac_ds = _dconv(bestrq_ac, params["d_conv_acoustic"], 2)

    phone = film(_linear(wavlm_ds, params["fusion_phone"]), rf, params["film_phone"])
    codes_phone, _ = rvq.encode(params["rvq_phone"], phone)
    sem = film(_linear(sem_ds, params["fusion_semantic"]), rf, params["film_semantic"])
    codes_sem, _ = rvq.encode(params["rvq_semantic"], sem)
    tl = min(ac_ds.shape[1], whisper_ds.shape[1])
    ac = torch.cat([ac_ds[:, :tl], whisper_ds[:, :tl]], -1)
    ac = film(_linear(ac, params["fusion_acoustic"]), rf, params["film_acoustic"])
    codes_ac, _ = rvq.encode(params["rvq_acoustic"], ac)

    tmin = min(codes_phone.shape[1], codes_sem.shape[1], codes_ac.shape[1])
    return torch.cat([codes_phone[:, :tmin], codes_sem[:, :tmin],
                      codes_ac[:, :tmin]], -1)


def tower_features(params: Params, enc_cfg: EncoderConfig, codec_cfg: CodecConfig,
                   wav: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One padded window (B, T) at the codec's rate -> the four tower
    features ("whisper", "wavlm" at 50 Hz, "bestrq_ac", "bestrq_sem"),
    lengths aligned as the encode aligns them."""
    sr = codec_cfg.sample_rate
    wav16 = mel.resample(wav, sr, 16000) if sr != 16000 else wav
    mels = mel.log_mel_spectrogram(wav16, enc_cfg.whisper.n_mels)
    # the whisper position table bounds the mel length (30 s = 3000)
    mels = mels[:, : enc_cfg.whisper.max_positions * 2]
    whisper_f = whisper_encoder.forward(params["whisper"], enc_cfg.whisper, mels)
    bestrq_ac, bestrq_sem = ssl_encoder.acoustic_semantic_features(
        params["ssl"], enc_cfg.ssl, wav, layers=enc_cfg.ssl_layers)
    wavlm_in = torch.cat([wav16, wav16.new_zeros((wav16.shape[0], 160))], -1)
    wavlm_f = wavlm_encoder.phone_features(params["wavlm"], enc_cfg.wavlm, wavlm_in)
    # length alignment (the reference's get_whisper_feature / get_wavlm_feature)
    len_sem = bestrq_sem.shape[1]
    return {"whisper": whisper_f[:, : min(whisper_f.shape[1], 2 * len_sem)],
            "wavlm": wavlm_f[:, : min(wavlm_f.shape[1], 2 * len_sem)],
            "bestrq_ac": bestrq_ac, "bestrq_sem": bestrq_sem}


def encode_features(params: Params, enc_cfg: EncoderConfig,
                    feats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tower features -> (reason_codes (B, T5, 8), rec_codes (B, T12.5, 8))."""
    reason_codes, reason_q = reasoning.encode(
        params["reasoning"], enc_cfg.reasoning, feats["whisper"], feats["bestrq_sem"])
    rec_codes = fuse_and_quantize(params, feats["whisper"], feats["wavlm"],
                                  feats["bestrq_ac"], feats["bestrq_sem"], reason_q)
    return reason_codes, rec_codes


def encode_window(params: Params, enc_cfg: EncoderConfig, codec_cfg: CodecConfig,
                  wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One padded window (B, T) at the codec's rate -> (reason_codes
    (B, T5, 8), rec_codes (B, T12.5, 8)), int32."""
    return encode_features(params, enc_cfg,
                           tower_features(params, enc_cfg, codec_cfg, wav))
