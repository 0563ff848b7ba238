"""BEST-RQ / MERT music-SSL tower, a wav2vec2 / HuBERT-style encoder (port
of `uniaudio2_tpu/codec/ssl_encoder.py`).

    [optional wav layer-norm] -> front end -> LayerNorm -> post-projection
    [-> affine-free LayerNorm] -> conv positional embedding -> layers

Front ends, as ``SSLEncoderConfig`` selects them:

* ``w2v_conv`` — the conv feature extractor (GroupNorm on conv 0 in the
  "default" extractor mode, optional conv bias, exact GELU);
* ``melspec`` — MERT's normalised log-mel (n_fft 2048, hop sr /
  label_rate, f_min 32.7, HTK mel scale without norm, window-normalised
  power, ``log(mel + 1e-5)``, one mean / Bessel-corrected std over the
  whole tensor, batch included);
* ``cqt_bins > 0`` — a CQT magnitude input (nnAudio CQT1992v2's kernels,
  hop sr / 50, bins_per_octave cqt_bins / 7, librosa's sqrt(length)
  scaling) concatenated onto the conv features, widening the projection's
  input to ``conv_dim[-1] + cqt_bins``.

The layers run pre-norm (``layer_norm_first``) or post-norm. Returns the
per-layer outputs in fairseq's ``layer_results`` order (index i = output
of layer i, no embedding entry).

Params (JAX key names; layers stacked on a leading L): convs [{"w", "b"?,
"gn_w"/"gn_b"?}], feat_ln_w/b, proj_w/b, pos_conv_w, pos_conv_b,
enc_ln_w/b, layers: q/k/v/out _w/_b, ln1_w/b, ff1_w/b, ff2_w/b, ln2_w/b.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uniaudio2_tpu_torch.codec.layers import (
    attend, conv, gelu, instance_norm_time, layer, layer_norm, normal, scores,
    split_heads,
)
from uniaudio2_tpu_torch.codec.mel import hann_window
from uniaudio2_tpu_torch.codec.wavlm_encoder import positional_conv

Params = Dict[str, Any]
FRONTENDS = ("w2v_conv", "melspec")


@dataclass(frozen=True)
class SSLEncoderConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    extractor_mode: str = "default"   # "default": group-norm on conv0 only
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_first: bool = False
    wav_normalize: bool = False
    layer_norm_eps: float = 1e-5
    frontend: str = "w2v_conv"        # "w2v_conv" | "melspec"
    sample_rate: int = 24000
    label_rate: int = 75              # front-end frame rate (mel hop = sr / this)
    melspec_n_bins: int = 84
    cqt_bins: int = 0                 # > 0 adds the CQT input
    stable_post_proj_ln: bool = False

    @property
    def feature_dim(self) -> int:
        """Channels entering the feature LayerNorm / post-projection."""
        if self.cqt_bins > 0:
            return self.conv_dim[-1] + self.cqt_bins
        if self.frontend == "melspec":
            return self.melspec_n_bins
        return self.conv_dim[-1]

    @classmethod
    def tiny_test(cls) -> "SSLEncoderConfig":
        return cls(conv_dim=(16,) * 3, conv_kernel=(10, 3, 2),
                   conv_stride=(5, 2, 2), hidden_size=32, num_layers=2,
                   num_heads=2, ffn_dim=64, pos_conv_kernel=16,
                   pos_conv_groups=2)


def init_params(generator: torch.Generator, cfg: SSLEncoderConfig,
                dtype=torch.float32, device="cuda") -> Params:
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"SSL front end {cfg.frontend!r} is not one of {FRONTENDS}")
    if cfg.cqt_bins > 0 and cfg.frontend != "w2v_conv":
        raise ValueError("the CQT input composes with the conv front end only")
    d, l, f = cfg.hidden_size, cfg.num_layers, cfg.ffn_dim

    def n(*shape):
        return normal(generator, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    convs, cin = [], 1
    if cfg.frontend == "w2v_conv":
        for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            c_p = {"w": n(k, cin, c)}
            if cfg.conv_bias:
                c_p["b"] = full(0.0, c)
            if i == 0 and cfg.extractor_mode == "default":
                c_p["gn_w"], c_p["gn_b"] = full(1.0, c), full(0.0, c)
            convs.append(c_p)
            cin = c
    fd = cfg.feature_dim
    return {
        "convs": convs,
        "feat_ln_w": full(1.0, fd), "feat_ln_b": full(0.0, fd),
        "proj_w": n(fd, d), "proj_b": full(0.0, d),
        "pos_conv_w": n(cfg.pos_conv_kernel, d // cfg.pos_conv_groups, d),
        "pos_conv_b": full(0.0, d),
        "enc_ln_w": full(1.0, d), "enc_ln_b": full(0.0, d),
        "layers": {
            "q_w": n(l, d, d), "q_b": full(0.0, l, d),
            "k_w": n(l, d, d), "k_b": full(0.0, l, d),
            "v_w": n(l, d, d), "v_b": full(0.0, l, d),
            "out_w": n(l, d, d), "out_b": full(0.0, l, d),
            "ln1_w": full(1.0, l, d), "ln1_b": full(0.0, l, d),
            "ff1_w": n(l, d, f), "ff1_b": full(0.0, l, f),
            "ff2_w": n(l, f, d), "ff2_b": full(0.0, l, d),
            "ln2_w": full(1.0, l, d), "ln2_b": full(0.0, l, d),
        },
    }


# ---------------------------------------------------------------------------
# MERT melspec front end
# ---------------------------------------------------------------------------


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def htk_fbank(sr: int, n_fft: int, n_mels: int, f_min: float) -> np.ndarray:
    """torchaudio ``melscale_fbanks(norm=None, mel_scale='htk')``:
    (n_fft // 2 + 1, n_mels) triangles on the HTK mel scale."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz_pts = _mel_to_hz_htk(np.linspace(
        _hz_to_mel_htk(np.array(f_min)), _hz_to_mel_htk(np.array(sr / 2.0)),
        n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).T.astype(np.float32)


def melspec_features(wav: torch.Tensor, *, sample_rate: int, label_rate: int,
                     n_bins: int, n_fft: int = 2048, f_min: float = 32.7) -> torch.Tensor:
    """(B, T) wav -> (B, 1 + T // hop, n_bins) standardised log-mels."""
    hop = sample_rate // label_rate
    half = n_fft // 2
    x = F.pad(wav.float(), (half, half))
    frames = x.unfold(-1, n_fft, hop)                     # 1 + T // hop
    window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / (window ** 2).sum()
    fb = torch.from_numpy(htk_fbank(sample_rate, n_fft, n_bins, f_min)).to(x.device)
    logmel = torch.log(power @ fb + 1e-5)
    mu = logmel.mean()
    std = torch.sqrt(((logmel - mu) ** 2).sum() / (logmel.numel() - 1))
    return (logmel - mu) / (std + 1e-5)


# ---------------------------------------------------------------------------
# CQT input
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def cqt_kernels(sr: int, n_bins: int, bins_per_octave: int, fmin: float = 32.7
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """nnAudio ``create_cqt_kernels`` (filter_scale 1, l1 norm, hann):
    (real (K, L), imag (K, L), lengths (K,), fft_len)."""
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = np.ceil(q * sr / freqs)
    fft_len = int(2 ** np.ceil(np.log2(lengths.max())))
    kern = np.zeros((n_bins, fft_len), np.complex128)
    for k in range(n_bins):
        n = int(lengths[k])
        start = int(np.ceil(fft_len / 2 - n / 2)) - (n % 2)
        t = np.arange((-n) // 2, n // 2)
        window = np.hanning(n + 1)[:-1] if n > 1 else np.ones(1)
        sig = window * np.exp(2j * np.pi * freqs[k] * t / sr) / n
        kern[k, start: start + n] = sig / np.linalg.norm(sig, 1)
    return (kern.real.astype(np.float32), kern.imag.astype(np.float32),
            lengths.astype(np.float32), fft_len)


def cqt_features(wav: torch.Tensor, *, sample_rate: int, n_bins: int) -> torch.Tensor:
    """(B, T) wav -> (B, 1 + T // hop, n_bins) CQT magnitudes, hop sr // 50."""
    real_k, imag_k, lengths, fft_len = cqt_kernels(sample_rate, n_bins, n_bins // 7)
    half = fft_len // 2
    x = F.pad(wav.float(), (half, half))[:, None]
    dev = x.device
    hop = sample_rate // 50
    re = F.conv1d(x, torch.from_numpy(real_k).to(dev)[:, None], stride=hop)
    im = -F.conv1d(x, torch.from_numpy(imag_k).to(dev)[:, None], stride=hop)
    mag = torch.sqrt(re ** 2 + im ** 2 + 1e-20).transpose(1, 2)
    return mag * torch.sqrt(torch.from_numpy(lengths).to(dev))


def feature_extractor(params: Params, cfg: SSLEncoderConfig, wav: torch.Tensor) -> torch.Tensor:
    if cfg.wav_normalize:
        xf = wav.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        wav = ((xf - mu) * torch.rsqrt(var + 1e-5)).to(wav.dtype)
    x = wav[:, :, None].to(params["convs"][0]["w"].dtype)
    for c_p, st in zip(params["convs"], cfg.conv_stride):
        x = conv(x, c_p["w"], stride=st)
        if "b" in c_p:
            x = x + c_p["b"]
        if "gn_w" in c_p:
            x = instance_norm_time(x, c_p["gn_w"], c_p["gn_b"])
        x = gelu(x)
    return x


def forward(params: Params, cfg: SSLEncoderConfig, wav: torch.Tensor
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(B, T) waveform -> (final output, [layer_0_out, ..., layer_{L-1}_out])."""
    eps = cfg.layer_norm_eps
    if cfg.frontend == "melspec":
        feats = melspec_features(
            wav, sample_rate=cfg.sample_rate, label_rate=cfg.label_rate,
            n_bins=cfg.melspec_n_bins).to(params["feat_ln_w"].dtype)
    else:
        feats = feature_extractor(params, cfg, wav)
        if cfg.cqt_bins > 0:
            cqt = cqt_features(wav, sample_rate=cfg.sample_rate,
                               n_bins=cfg.cqt_bins)[:, : feats.shape[1]]
            feats = torch.cat([feats, cqt.to(feats.dtype)], dim=-1)
    h = layer_norm(feats, params["feat_ln_w"], params["feat_ln_b"], eps)
    h = h @ params["proj_w"] + params["proj_b"]
    if cfg.stable_post_proj_ln:
        h = layer_norm(h, None, None, eps)
    h = h + gelu(positional_conv(h, params["pos_conv_w"], params["pos_conv_b"],
                                 cfg.pos_conv_kernel, cfg.pos_conv_groups))
    if not cfg.layer_norm_first:
        h = layer_norm(h, params["enc_ln_w"], params["enc_ln_b"], eps)

    heads = cfg.num_heads
    hd = cfg.hidden_size // heads
    outs = []
    for i in range(params["layers"]["q_w"].shape[0]):
        lp = layer(params["layers"], i)
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"], eps) if cfg.layer_norm_first else h
        q = split_heads(hn @ lp["q_w"] + lp["q_b"], heads)
        k = split_heads(hn @ lp["k_w"] + lp["k_b"], heads)
        v = split_heads(hn @ lp["v_w"] + lp["v_b"], heads)
        h = h + (attend(scores(q, k) * (hd ** -0.5), v) @ lp["out_w"] + lp["out_b"])
        if cfg.layer_norm_first:
            hn = layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)
            h = h + (gelu(hn @ lp["ff1_w"] + lp["ff1_b"]) @ lp["ff2_w"] + lp["ff2_b"])
        else:
            h = layer_norm(h, lp["ln1_w"], lp["ln1_b"], eps)
            h = h + (gelu(h @ lp["ff1_w"] + lp["ff1_b"]) @ lp["ff2_w"] + lp["ff2_b"])
            h = layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)
        outs.append(h)
    final = h
    if cfg.layer_norm_first:
        final = layer_norm(final, params["enc_ln_w"], params["enc_ln_b"], eps)
    return final, outs


def acoustic_semantic_features(params: Params, cfg: SSLEncoderConfig, wav: torch.Tensor,
                               layers: Tuple[int, int] = (4, 11)
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acoustic, semantic) = layer_results[4], layer_results[11], (B, T, D)."""
    _, outs = forward(params, cfg, wav)
    return outs[layers[0]], outs[layers[1]]
