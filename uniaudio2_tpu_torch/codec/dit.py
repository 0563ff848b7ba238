"""Flow-matching DiT, the codec's latent decoder (port of
`uniaudio2_tpu/codec/dit.py`).

A PixArt-alpha-style 1-D DiT: conv(k=3) + linear input projection (scaled
by k^-0.5), additive interleaved sinusoidal positions, N pre-norm blocks
with adaLN-single conditioning (one global silu -> linear(D -> 6D) of the
flow-time embedding plus a per-block (6, D) shift table), self-attention
with QKV bias, a GELU(tanh) MLP x4, then a final LayerNorm, a (2, D)
scale-shift table and a conv + linear output projection.

Shipped shape: 32 layers x 24 heads x 64 head-dim (D = 1536), in 1040
(136 noisy latent | 136 in-context latent | 768 condition), out 136.

The self-attention picks its path by dtype and head dim as the JAX DiT's
`_flash_ok` does (`flash_ok`): bf16 and float32 at a head dim the kernels
are built for (`flash_attention.HEAD_DIMS`) run
`ops.flash_attention.flash_attention`, the hand-written CUDA kernels on
the card (``flash_attn.cu`` in bf16, ``flash_attn_f32.cu`` in float32)
and their plain twin on the CPU; every other head dim (the tiny config's
16) runs `flash_attention.attention_plain`, the JAX einsum path, on any
device. Two differences from `_flash_ok`: the kernels run at every T,
since they mask T themselves (the JAX gate's T >= 128 is a TPU tuning
choice), and hd 256, which no DiT configuration has, takes the einsum
path. ``_attention.plain_launches`` counts the calls that took it.
The matrix products stay ``torch.matmul``, as they are XLA code in the
JAX package.

Params (JAX key names and layouts; convs (k, C_in, C_out), linears
(in, out), blocks stacked on a leading L):
    proj_in:  conv_w, conv_b, lin_w, lin_b
    t_embed:  w1 (512, D), b1, w2 (D, D), b2
    adaln:    w (D, 6D), b (6D,)
    blocks:   sst (L, 6, D), qkv_w (L, D, 3D), qkv_b, attn_out_w (L, D, D),
              attn_out_b, ff1_w (L, D, 4D), ff1_b, ff2_w (L, 4D, D), ff2_b
    out:      sst (2, D), conv_w (k, D, C_out), conv_b, lin_w, lin_b
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from uniaudio2_tpu_torch.codec.scalar_ae import conv_weight_layout
from uniaudio2_tpu_torch.ops import flash_attention

Params = Dict[str, Any]


@dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 1040
    out_channels: int = 136
    num_layers: int = 32
    num_heads: int = 24
    head_dim: int = 64
    norm_eps: float = 1e-6
    flow_t_size: int = 512
    max_positions: int = 3000
    proj_kernel: int = 3

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim

    @classmethod
    def tiny(cls) -> "DiTConfig":
        return cls(in_channels=20, out_channels=8, num_layers=2,
                   num_heads=2, head_dim=16, max_positions=256)


def init_params(generator: torch.Generator, cfg: DiTConfig,
                dtype=torch.float32, device="cuda") -> Params:
    d, n_l, k = cfg.dim, cfg.num_layers, cfg.proj_kernel

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def normal(*shape):
        return (randn(*shape) * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "proj_in": {"conv_w": normal(k, cfg.in_channels, d), "conv_b": zeros(d),
                    "lin_w": normal(d, d), "lin_b": zeros(d)},
        "t_embed": {"w1": normal(cfg.flow_t_size, d), "b1": zeros(d),
                    "w2": normal(d, d), "b2": zeros(d)},
        "adaln": {"w": normal(d, 6 * d), "b": zeros(6 * d)},
        "blocks": {
            "sst": (randn(n_l, 6, d) / d ** 0.5).to(dtype),
            "qkv_w": normal(n_l, d, 3 * d), "qkv_b": zeros(n_l, 3 * d),
            "attn_out_w": normal(n_l, d, d), "attn_out_b": zeros(n_l, d),
            "ff1_w": normal(n_l, d, 4 * d), "ff1_b": zeros(n_l, 4 * d),
            "ff2_w": normal(n_l, 4 * d, d), "ff2_b": zeros(n_l, d),
        },
        "out": {
            "sst": (randn(2, d) / d ** 0.5).to(dtype),
            "conv_w": normal(k, d, cfg.out_channels),
            "conv_b": zeros(cfg.out_channels),
            "lin_w": torch.eye(cfg.out_channels, dtype=dtype, device=device),
            "lin_b": zeros(cfg.out_channels),
        },
    }


def prepare_params(params: Params) -> Params:
    """The same tree with both conv weights stored so that F.conv1d's
    (C_out, C_in, k) view of them is contiguous (done once, not per call)."""
    out = dict(params)
    for name in ("proj_in", "out"):
        out[name] = dict(params[name],
                         conv_w=conv_weight_layout(params[name]["conv_w"]))
    return out


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine, in f32, cast back to ``x.dtype``."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) conv (k, C_in, C_out) with SAME padding -> (B, T, C_out)
    in ``x.dtype``."""
    k = w.shape[0]
    lo = (k - 1) // 2
    h = F.pad(x.to(w.dtype).transpose(1, 2), (lo, k - 1 - lo))
    out = F.conv1d(h, w.permute(2, 1, 0), b)
    return out.transpose(1, 2).to(x.dtype)


def _project(p: Params, x: torch.Tensor, kernel: int) -> torch.Tensor:
    """ProjectLayer: conv(k) scaled by k^-0.5, then linear."""
    h = _conv1d_same(x, p["conv_w"], p["conv_b"]) * (kernel ** -0.5)
    return h @ p["lin_w"] + p["lin_b"]


def flow_time_embedding(t: torch.Tensor, size: int) -> torch.Tensor:
    """Sinusoidal embedding of the flow time, x1000, cos | sin. t: (B,) ->
    (B, size) f32."""
    half = size // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=16)
def _sinusoidal_positions(length: int, dim: int, device: torch.device) -> torch.Tensor:
    """The first ``length`` rows of the interleaved sin/cos position table
    (diffusers `SinusoidalPositionalEmbedding`), f32."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def flash_ok(dtype: torch.dtype, hd: int) -> bool:
    """Whether the DiT's attention of this dtype and head dim goes to the
    flash kernels (else to the einsum path)."""
    return dtype in flash_attention.DTYPES and hd in flash_attention.HEAD_DIMS


def _attention(x: torch.Tensor, qkv_w, qkv_b, out_w, out_b,
               num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // num_heads
    qkv = (x @ qkv_w + qkv_b).reshape(b, t, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)  # (B, H, T, hd)
    if flash_ok(q.dtype, hd):
        o = flash_attention.flash_attention(q, k, v, hd ** -0.5)
    else:
        o = flash_attention.attention_plain(q, k, v, hd ** -0.5)
        _attention.plain_launches += 1
    return o.transpose(1, 2).reshape(b, t, d) @ out_w + out_b


_attention.plain_launches = 0


def forward(params: Params, cfg: DiTConfig, x: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
    """One estimator evaluation: x (B, T, in_channels), t (B,) flow time in
    [0, 1] -> the predicted velocity (B, T, out_channels)."""
    b, tl, _ = x.shape
    h = _project(params["proj_in"], x, cfg.proj_kernel)
    h = h + _sinusoidal_positions(tl, cfg.dim, h.device).to(h.dtype)[None]

    te = flow_time_embedding(t, cfg.flow_t_size)           # (B, 512) f32
    emb = params["t_embed"]
    te = F.silu(te @ emb["w1"].float() + emb["b1"].float())
    te = (te @ emb["w2"].float() + emb["b2"].float()).to(h.dtype)
    ada = F.silu(te) @ params["adaln"]["w"] + params["adaln"]["b"]
    ada = ada.reshape(b, 6, cfg.dim)                        # shared by layers

    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        mods = blocks["sst"][i][None] + ada                 # (B, 6, D)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (
            mods[:, j][:, None, :] for j in range(6))
        hn = _layer_norm(h, cfg.norm_eps) * (1 + sc_msa) + sh_msa
        attn = _attention(hn, blocks["qkv_w"][i], blocks["qkv_b"][i],
                          blocks["attn_out_w"][i], blocks["attn_out_b"][i],
                          cfg.num_heads)
        h = h + g_msa * attn
        hn = _layer_norm(h, cfg.norm_eps) * (1 + sc_mlp) + sh_mlp
        ff = F.gelu(hn @ blocks["ff1_w"][i] + blocks["ff1_b"][i],
                    approximate="tanh")
        h = h + g_mlp * (ff @ blocks["ff2_w"][i] + blocks["ff2_b"][i])

    out_mods = params["out"]["sst"][None] + te[:, None, :]
    shift, scale = out_mods[:, 0][:, None], out_mods[:, 1][:, None]
    h = _layer_norm(h, 1e-6) * (1 + scale) + shift
    return _project(params["out"], h, cfg.proj_kernel)
