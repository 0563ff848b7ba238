"""SQ-codec waveform autoencoder (port of `uniaudio2_tpu/codec/scalar_ae.py`).

Symmetric conv pyramids with per-stage residual-unit stacks (dilations
1/3/5/7/9), PReLU activations, repeat post-processing and a scalar rounding
quantizer (``round(9 x) / 9``) in front of the decoder. Shipped latent: 136
dims at 25 Hz, 960x total stride to 24 kHz. The real stage geometry lives
in the checkpoint's YAML, which is not in the repository;
`ScalarAEConfig.default_24k()` carries a 960x geometry of the same family.

The convs are ``F.conv1d`` / ``F.conv_transpose1d`` (XLA code in the JAX
package). The public `encode` and `decode` take and return (B, T, C) like
the JAX functions; inside, the activations stay in torch's (B, C, T)
layout, so the private conv helpers take (B, C, T).

Params (JAX key names and layouts): per conv {"w": (k, C_in, C_out),
"b": (C_out,)}, PReLU slopes (1,); "pre" and "post" are None when
``num_samples == 1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class ScalarAEConfig:
    num_bands: int = 1
    sample_rate: int = 24000
    causal: bool = False
    num_samples: int = 2                       # pre/post pool factor
    downsample_factors: Tuple[int, ...] = (8, 5, 4, 3)
    downsample_kernel_sizes: Tuple[int, ...] = (16, 10, 8, 6)
    upsample_factors: Tuple[int, ...] = (3, 4, 5, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (6, 8, 10, 16)
    latent_hidden_dim: int = 136
    default_kernel_size: int = 7
    delay_kernel_size: int = 5
    init_channel: int = 48
    res_kernel_size: int = 7
    rounds: int = 9                            # round(N x) / N quantizer

    @property
    def total_stride(self) -> int:
        s = self.num_samples
        for f in self.downsample_factors:
            s *= f
        return s

    @classmethod
    def default_24k(cls) -> "ScalarAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ScalarAEConfig":
        return cls(num_samples=1, downsample_factors=(2, 2),
                   downsample_kernel_sizes=(4, 4), upsample_factors=(2, 2),
                   upsample_kernel_sizes=(4, 4), latent_hidden_dim=8,
                   init_channel=4, default_kernel_size=3,
                   delay_kernel_size=3, res_kernel_size=3)


def conv_weight_layout(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """``w`` (k, C_in, C_out), same shape and values, stored so that its
    torch view is contiguous: ``w.permute(2, 1, 0)`` (C_out, C_in, k) for
    F.conv1d, or ``w.permute(1, 2, 0)`` (C_in, C_out, k) for
    F.conv_transpose1d."""
    if transposed:
        return w.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    return w.permute(2, 1, 0).contiguous().permute(2, 1, 0)


# ---------------------------------------------------------------------------
# Primitive ops, on (B, C, T)
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, p: Params, *, stride: int = 1, dilation: int = 1,
          causal: bool = False) -> torch.Tensor:
    """1-D conv with torch-style symmetric ((k d - d) // 2 on both sides,
    also for even k) or causal-left padding."""
    k = p["w"].shape[0]
    w = p["w"].permute(2, 1, 0)
    if causal:
        x = F.pad(x, (dilation * (k - 1), 0))
        pad = 0
    else:
        pad = (k * dilation - dilation) // 2
    return F.conv1d(x, w, p["b"], stride=stride, padding=pad, dilation=dilation)


def _conv_transpose(x: torch.Tensor, p: Params, *, stride: int,
                    causal: bool = False) -> torch.Tensor:
    """ConvTranspose1d with padding (k - stride) // 2 (non-causal; k = 10,
    stride 5 gives 5 T + 1 samples), or causal with the last ``stride``
    samples cropped."""
    k = p["w"].shape[0]
    pad = 0 if causal else (k - stride) // 2
    out = F.conv_transpose1d(x, p["w"].permute(1, 2, 0), p["b"], stride=stride,
                             padding=pad)
    return out[:, :, :-stride] if causal else out


def scalar_quantize(x: torch.Tensor, rounds: int = 9) -> torch.Tensor:
    """``round(N x) / N`` in f32, applied as ``x + (q - x)`` in ``x.dtype``
    (the JAX straight-through form, same rounding)."""
    q = torch.round(x.float() * float(rounds)) / float(rounds)
    return x + (q.to(x.dtype) - x)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ScalarAEConfig,
                dtype=torch.float32, device="cuda") -> Params:
    def uniform(shape, s):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return ((u * 2.0 - 1.0) * s).to(dtype)

    def conv(k, cin, cout):
        s = (1.0 / (cin * k)) ** 0.5
        return {"w": uniform((k, cin, cout), s), "b": uniform((cout,), s)}

    def slope():
        return torch.full((1,), 0.25, dtype=dtype, device=device)

    def res_unit(c):
        return {"conv1": conv(cfg.res_kernel_size, c, c), "conv2": conv(1, c, c),
                "a1": slope(), "a2": slope()}

    nd = len(cfg.downsample_factors)
    ic = cfg.init_channel
    enc_in = conv(cfg.default_kernel_size, cfg.num_bands, ic)
    pre = None
    if cfg.num_samples > 1:
        pre = {"conv": conv(cfg.default_kernel_size, ic, ic), "a": slope()}
    enc_blocks: List[Params] = []
    for i in range(nd):
        cin, cout = ic * 2 ** i, ic * 2 ** (i + 1)
        units = [res_unit(cin) for _ in range(5)]
        down = {"conv": conv(cfg.downsample_kernel_sizes[i], cin, cout),
                "a": slope()}
        enc_blocks.append({"units": units, "down": down})
    enc_out = conv(cfg.default_kernel_size, ic * 2 ** nd, cfg.latent_hidden_dim)
    dec_in = conv(cfg.delay_kernel_size, cfg.latent_hidden_dim, ic * 2 ** nd)
    dec_blocks: List[Params] = []
    for i in range(len(cfg.upsample_factors)):
        cin, cout = ic * 2 ** (nd - i), ic * 2 ** (nd - i - 1)
        up = {"conv": conv(cfg.upsample_kernel_sizes[i], cin, cout), "a": slope()}
        dec_blocks.append({"up": up, "units": [res_unit(cout) for _ in range(5)]})
    post = None
    if cfg.num_samples > 1:
        post = {"conv": conv(cfg.default_kernel_size, ic, ic), "a": slope()}
    dec_out = conv(cfg.default_kernel_size, ic, cfg.num_bands)
    return {"enc_in": enc_in, "pre": pre, "enc_blocks": enc_blocks,
            "enc_out": enc_out, "dec_in": dec_in, "dec_blocks": dec_blocks,
            "post": post, "dec_out": dec_out}


def prepare_params(params: Params) -> Params:
    """The decoder's conv weights stored in their torch layout
    (`conv_weight_layout`), once; the encoder's leaves are kept as they
    are."""
    def conv(p):
        return dict(p, w=conv_weight_layout(p["w"]))

    def unit(u):
        return dict(u, conv1=conv(u["conv1"]), conv2=conv(u["conv2"]))

    out = dict(params, dec_in=conv(params["dec_in"]),
               dec_out=conv(params["dec_out"]))
    out["dec_blocks"] = [
        {"up": dict(blk["up"], conv=dict(
            blk["up"]["conv"],
            w=conv_weight_layout(blk["up"]["conv"]["w"], transposed=True))),
         "units": [unit(u) for u in blk["units"]]}
        for blk in params["dec_blocks"]]
    if params["post"] is not None:
        out["post"] = dict(params["post"], conv=conv(params["post"]["conv"]))
    return out


# ---------------------------------------------------------------------------
# Encode and decode
# ---------------------------------------------------------------------------


def _res_unit(x: torch.Tensor, p: Params, cfg: ScalarAEConfig,
              dilation: int) -> torch.Tensor:
    h = F.prelu(_conv(x, p["conv1"], dilation=dilation, causal=cfg.causal), p["a1"])
    h = F.prelu(_conv(h, p["conv2"], causal=cfg.causal), p["a2"])
    return h + x


_DILATIONS = (1, 3, 5, 7, 9)


def encode(params: Params, cfg: ScalarAEConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B, T, num_bands) waveform -> (B, T / stride, latent) tanh-bounded
    embedding before the scalar quantizer (`decode` applies it)."""
    x = _conv(wav.to(params["enc_in"]["w"].dtype).transpose(1, 2),
              params["enc_in"], causal=cfg.causal)
    if params["pre"] is not None:
        x = F.prelu(_conv(x, params["pre"]["conv"], causal=cfg.causal),
                    params["pre"]["a"])
        # AvgPool1d(kernel=num_samples): non-overlapping means over time
        b, c, t = x.shape
        t2 = t - t % cfg.num_samples
        x = x[:, :, :t2].reshape(b, c, t2 // cfg.num_samples,
                                 cfg.num_samples).mean(-1)
    for blk, f in zip(params["enc_blocks"], cfg.downsample_factors):
        for u, d in zip(blk["units"], _DILATIONS):
            x = _res_unit(x, u, cfg, d)
        x = F.prelu(_conv(x, blk["down"]["conv"], stride=f, causal=cfg.causal),
                    blk["down"]["a"])
    return torch.tanh(_conv(x, params["enc_out"], causal=cfg.causal)).transpose(1, 2)


def decode(params: Params, cfg: ScalarAEConfig, latent: torch.Tensor) -> torch.Tensor:
    """(B, T_lat, latent) -> (B, T_out, num_bands) in the parameters' dtype.
    Applies the scalar quantizer first."""
    x = scalar_quantize(latent, cfg.rounds).to(params["dec_in"]["w"].dtype)
    x = _conv(x.transpose(1, 2), params["dec_in"])  # look-ahead conv: never causal
    for blk, f in zip(params["dec_blocks"], cfg.upsample_factors):
        x = F.prelu(_conv_transpose(x, blk["up"]["conv"], stride=f,
                                   causal=cfg.causal), blk["up"]["a"])
        for u, d in zip(blk["units"], _DILATIONS):
            x = _res_unit(x, u, cfg, d)
    if params["post"] is not None:
        x = x.repeat_interleave(cfg.num_samples, dim=2)
        x = F.prelu(_conv(x, params["post"]["conv"], causal=cfg.causal),
                   params["post"]["a"])
    return _conv(x, params["dec_out"], causal=cfg.causal).transpose(1, 2)
