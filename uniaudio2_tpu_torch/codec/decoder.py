"""Codec decode path: tokens -> latents -> 24 kHz waveform (port of
`uniaudio2_tpu/codec/decoder.py`).

1. three reconstruction RVQ inverse lookups (phone 1q | structure 1q |
   acoustic 6q), summed;
2. optional reasoning fusion: reasoning-RVQ lookup -> linear adaptor ->
   x2.5 nearest upsample -> added;
3. condition embedding linear + x2 nearest upsample to 25 Hz;
4. the Euler CFM solve with CFG over the DiT estimator (`cfm`, `dit`);
5. the ScalarAE conv decode to the waveform (`scalar_ae`).

`decode_chunk` runs steps 1-4 for one window on the parameters' device;
`CodecDecoder.decode` keeps the windowing on the host: 30 s windows (or a
quarter / half window for a clip that fits in one), a 3/4-window hop, the
in-context latent carry-over between windows and the linear crossfade of
the waveforms, in numpy. The waveform leaves the device once per window.

Noise: each window's solver noise comes from a ``torch.Generator`` seeded
with ``seed`` on the decoder's device, drawn in window order, unless a
``noise_fn(window_index, shape)`` supplies it (the tests hand in the JAX
decoder's threefry draws that way).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from uniaudio2_tpu_torch.codec import cfm, dit, rvq, scalar_ae
from uniaudio2_tpu_torch.codec.dit import DiTConfig
from uniaudio2_tpu_torch.codec.scalar_ae import ScalarAEConfig

Params = Dict[str, Any]
NoiseFn = Callable[[int, tuple], Any]


@dataclass(frozen=True)
class CodecConfig:
    """Geometry of the ReasoningCodec."""

    sample_rate: int = 24000
    codec_dim: int = 768
    latent_dim: int = 136
    sq_hz: float = 25.0
    rec_hz: float = 12.5
    reason_hz: float = 5.0
    num_codebooks: int = 8
    rec_codebook_size: int = 8192
    reason_codebook_size: int = 4096
    rec_codebook_dim: int = 32
    reason_codebook_dim: int = 64
    window_seconds: float = 30.0
    dit: DiTConfig = DiTConfig()
    scalar: ScalarAEConfig = ScalarAEConfig()

    @property
    def window_rec_frames(self) -> int:
        return int(self.window_seconds * self.rec_hz)

    @property
    def window_reason_frames(self) -> int:
        return int(self.window_seconds * self.reason_hz)

    @property
    def window_latent_frames(self) -> int:
        return int(self.window_seconds * self.sq_hz)

    @classmethod
    def tiny(cls) -> "CodecConfig":
        return cls(
            # 100 Hz audio, 25 Hz latents, the tiny ScalarAE's 4x stride
            sample_rate=100,
            codec_dim=16, latent_dim=8, num_codebooks=8,
            rec_codebook_size=32, reason_codebook_size=16,
            rec_codebook_dim=8, reason_codebook_dim=8,
            window_seconds=2.0,
            dit=DiTConfig(in_channels=8 + 8 + 16, out_channels=8,
                          num_layers=2, num_heads=2, head_dim=8,
                          max_positions=256),
            scalar=ScalarAEConfig.tiny(),
        )


def init_decode_params(generator: torch.Generator, cfg: CodecConfig,
                       dtype=torch.float32, device="cuda") -> Params:
    d = cfg.codec_dim

    def normal(*shape, std=1.0):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def codebook(size, dim, q):
        return rvq.init_params(generator, dim=d, codebook_size=size,
                               codebook_dim=dim, num_quantizers=q, dtype=dtype,
                               device=device)

    rec = (cfg.rec_codebook_size, cfg.rec_codebook_dim)
    return {
        "rvq_phone": codebook(*rec, 1),
        "rvq_semantic": codebook(*rec, 1),
        "rvq_acoustic": codebook(*rec, 6),
        "rvq_reasoning": codebook(cfg.reason_codebook_size,
                                  cfg.reason_codebook_dim, 8),
        "reason_adaptor": {"w": normal(d, d, std=0.02),
                           "b": torch.zeros((d,), dtype=dtype, device=device)},
        "cond_feature_emb": {"w": normal(d, d, std=0.02),
                             "b": torch.zeros((d,), dtype=dtype, device=device)},
        "zero_cond_embedding": normal(d),
        "dit": dit.init_params(generator, cfg.dit, dtype=dtype, device=device),
        "scalar": scalar_ae.init_params(generator, cfg.scalar, dtype=dtype,
                                        device=device),
    }


def prepare_decode_params(params: Params) -> Params:
    """The same tree with every conv weight of the decode path stored in its
    torch layout, once (`scalar_ae.conv_weight_layout`)."""
    return dict(params, dit=dit.prepare_params(params["dit"]),
                scalar=scalar_ae.prepare_params(params["scalar"]))


# ---------------------------------------------------------------------------
# Conditioning
# ---------------------------------------------------------------------------


def _upsample_nearest(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``F.interpolate(mode='nearest', scale_factor=s)`` on the time axis of
    (B, T, C): out[i] = in[floor(i / s)], length floor(T s); the index is
    computed in f32, as the JAX function does."""
    t = x.shape[1]
    out_t = int(math.floor(t * scale))
    idx = torch.floor(torch.arange(out_t, dtype=torch.float32, device=x.device)
                      / scale).long()
    return x[:, idx.clamp(max=t - 1)]


def condition_features(params: Params, cfg: CodecConfig, rec_codes: torch.Tensor,
                       reason_codes: Optional[torch.Tensor]) -> torch.Tensor:
    """Codes (B, T_rec, 8) [+ reasoning codes (B, T_reason, 8)] ->
    (B, 2 T_rec, codec_dim) conditioning at 25 Hz (steps 1-3)."""
    feats = (rvq.decode(params["rvq_phone"], rec_codes[:, :, 0:1])
             + rvq.decode(params["rvq_semantic"], rec_codes[:, :, 1:2])
             + rvq.decode(params["rvq_acoustic"], rec_codes[:, :, 2:8]))
    if reason_codes is not None:
        r = rvq.decode(params["rvq_reasoning"], reason_codes)
        r = r @ params["reason_adaptor"]["w"] + params["reason_adaptor"]["b"]
        r = _upsample_nearest(r, 2.5)
        tl = feats.shape[1]
        r = r[:, :tl]
        if r.shape[1] < tl:
            r = torch.nn.functional.pad(r, (0, 0, 0, tl - r.shape[1]))
        feats = feats + r
    feats = feats @ params["cond_feature_emb"]["w"] + params["cond_feature_emb"]["b"]
    return _upsample_nearest(feats, 2.0)


def decode_chunk(
    params: Params,
    cfg: CodecConfig,
    rec_codes: torch.Tensor,           # (B, T_rec, 8)
    reason_codes: Optional[torch.Tensor],
    incontext_latent: torch.Tensor,    # (B, T_lat, latent_dim)
    incontext_len: int,
    noise: torch.Tensor,               # (B, T_lat, latent_dim)
    *,
    num_steps: int,
    guidance_scale: float,
) -> torch.Tensor:
    """One window: codes (+ an in-context latent prefix) -> latents
    (B, 2 T_rec, latent_dim) f32. The JAX function also gates the condition
    with the learned ``zero_cond_embedding`` on pad frames; a window has
    none (its mask is all True), so that select is the identity and is not
    repeated here."""
    mu = condition_features(params, cfg, rec_codes, reason_codes)
    tl = mu.shape[1]
    ctx_mask = (torch.arange(tl, device=mu.device) < incontext_len)[None]
    ctx_mask = ctx_mask.expand(mu.shape[0], tl)
    ctx_latent = incontext_latent * ctx_mask[..., None].to(incontext_latent.dtype)

    # the DiT runs in its parameter dtype (bf16 in production), the solver
    # in f32
    dit_dtype = params["dit"]["proj_in"]["conv_w"].dtype

    def estimator(x_cat, t):
        v = dit.forward(params["dit"], cfg.dit, x_cat.to(dit_dtype), t)
        return v.to(x_cat.dtype)

    return cfm.solve_euler(
        estimator, noise=noise, mu=mu, incontext_x=ctx_latent,
        incontext_mask=ctx_mask, num_steps=num_steps,
        guidance_scale=guidance_scale)


# ---------------------------------------------------------------------------
# Host-side windowed decode
# ---------------------------------------------------------------------------


def _pad_repeat(codes: np.ndarray, target: int) -> np.ndarray:
    """Pad (B, T, K) along T to ``target`` by self-repetition."""
    while codes.shape[1] < target:
        codes = np.concatenate([codes, codes], axis=1)
    return codes[:, :target]


def _pad_to_hops(codes: np.ndarray, win: int) -> np.ndarray:
    """Repeat-pad (B, T, K) along T to one window of ``win`` frames, or to
    one window plus a whole number of 3/4-window hops."""
    hop = win // 4 * 3
    ovlp = win - hop
    t = codes.shape[1]
    if t < win:
        return _pad_repeat(codes, win)
    if (t - ovlp) % hop:
        return _pad_repeat(codes, math.ceil((t - ovlp) / hop) * hop + ovlp)
    return codes


class CodecDecoder:
    """Tokens -> waveform with 30 s windows, 3/4-window hop, in-context
    latent carry-over and linear crossfade. Runs on the device of
    ``params``; the conv weights are re-laid once here
    (`prepare_decode_params`)."""

    def __init__(self, params: Params, cfg: CodecConfig):
        self.params = prepare_decode_params(params)
        self.cfg = cfg
        self.device = params["rvq_phone"]["codebooks"].device

    def _noise(self, gen: torch.Generator, noise_fn: Optional[NoiseFn],
               index: int, shape: tuple) -> torch.Tensor:
        if noise_fn is not None:
            return torch.as_tensor(np.array(noise_fn(index, shape), np.float32),
                                   device=self.device)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32)

    def _solve(self, cfg: CodecConfig, rec: np.ndarray,
               reason: Optional[np.ndarray], prev: Optional[torch.Tensor],
               noise: torch.Tensor, num_steps: int,
               guidance: float) -> torch.Tensor:
        """One window: rec (1, win, 8) [reason (1, win_q, 8)] with the
        previous window's latents ``prev`` carried in -> latents."""
        lat_frames = 2 * cfg.window_rec_frames
        ovlp_lat = 2 * (cfg.window_rec_frames - cfg.window_rec_frames // 4 * 3)
        ctx = torch.zeros((1, lat_frames, cfg.latent_dim), dtype=torch.float32,
                          device=self.device)
        ctx_len = 0
        if prev is not None:
            ctx[:, :ovlp_lat] = prev[:, -ovlp_lat:]
            ctx_len = ovlp_lat

        def dev(codes):
            return torch.as_tensor(codes, dtype=torch.int64, device=self.device)

        return decode_chunk(
            self.params, cfg, dev(rec), None if reason is None else dev(reason),
            ctx, ctx_len, noise, num_steps=num_steps, guidance_scale=guidance)

    def _waveform(self, cfg: CodecConfig, lat: torch.Tensor) -> np.ndarray:
        """ScalarAE decode of one window's latents, cut to the window ->
        (1, win_samples) f32 on the host."""
        wav = scalar_ae.decode(self.params["scalar"], cfg.scalar, lat)
        win_samp = int(cfg.window_seconds * cfg.sample_rate)
        return wav[0, :win_samp, 0][None].float().cpu().numpy()

    def decode(
        self,
        rec_codes: np.ndarray,                       # (8, T_rec) int
        reason_codes: Optional[np.ndarray] = None,   # (8, T_reason) int
        *,
        num_steps: int = 10,
        guidance_scale: float = 1.5,
        seed: int = 0,
        noise_fn: Optional[NoiseFn] = None,
    ) -> np.ndarray:
        """Returns the waveform (1, int(T_rec / rec_hz * sample_rate)) f32."""
        cfg = self.cfg
        if cfg.window_rec_frames < 4 or cfg.window_reason_frames < 4:
            raise ValueError(
                f"window_seconds={cfg.window_seconds} gives a degenerate "
                f"chunk geometry (rec {cfg.window_rec_frames} / reason "
                f"{cfg.window_reason_frames} frames; the 3/4 hop needs >= 4)")
        t_rec_orig = rec_codes.shape[-1]
        target_samples = int(t_rec_orig / cfg.rec_hz * cfg.sample_rate)

        # a clip that fits one quarter or half window solves that window
        # only; multi-window audio keeps the full window
        for frac in (4, 2):
            cand = cfg.window_seconds / frac
            if (t_rec_orig <= int(cand * cfg.rec_hz)
                    and int(cand * cfg.rec_hz) >= 4
                    and int(cand * cfg.reason_hz) >= 4):
                cfg = dataclasses.replace(cfg, window_seconds=cand)
                break

        win, win_q = cfg.window_rec_frames, cfg.window_reason_frames
        hop, hop_q = win // 4 * 3, win_q // 4 * 3
        rec = _pad_to_hops(np.asarray(rec_codes, np.int64).T[None], win)  # (1, T, 8)
        reason = None
        if reason_codes is not None:
            reason = _pad_to_hops(np.asarray(reason_codes, np.int64).T[None], win_q)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (1, 2 * win, cfg.latent_dim)
        latents = []
        for cnt, start in enumerate(range(0, rec.shape[1] - hop, hop)):
            reason_in = (None if reason is None
                         else reason[:, hop_q * cnt: hop_q * cnt + win_q])
            latents.append(self._solve(
                cfg, rec[:, start: start + win], reason_in,
                latents[-1] if latents else None,
                self._noise(gen, noise_fn, cnt, shape), num_steps,
                guidance_scale))

        # ScalarAE decode + linear crossfade stitch, on the host
        win_samp = int(cfg.window_seconds * cfg.sample_rate)
        ovlp_samp = win_samp - win_samp // 4 * 3
        out = None
        for lat in latents:
            wav = self._waveform(cfg, lat)
            if out is None:
                out = wav
            else:
                ramp = np.linspace(0, 1, ovlp_samp, dtype=np.float32)[None]
                out[:, -ovlp_samp:] = (out[:, -ovlp_samp:] * (1.0 - ramp)
                                       + wav[:, :ovlp_samp] * ramp)
                out = np.concatenate([out, wav[:, ovlp_samp:]], axis=-1)
        return out[:, :target_samples]
