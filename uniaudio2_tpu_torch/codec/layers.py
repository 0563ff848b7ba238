"""Building blocks shared by the encode path's towers (`whisper_encoder`,
`wavlm_encoder`, `ssl_encoder`, `reasoning`, `encoder`).

Activations are (B, T, C) as in the JAX package; conv weights keep the JAX
TIO layout (k, C_in / groups, C_out) and are viewed as torch's
(C_out, C_in / groups, k) at the call. Attention is the JAX towers'
einsum + float32 softmax, as plain contractions (no Pallas kernel there).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32, as the JAX ``_ln`` writes
    it (mean, then the mean of squared deviations); no affine when ``w`` is
    None."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w + b
    return y.to(x.dtype)


def instance_norm_time(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GroupNorm(C groups, C) of (B, T, C): per channel over time, eps 1e-5."""
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = ((xf - mu) ** 2).mean(1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * w + b).to(x.dtype)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
         stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """(B, T, C_in) with a TIO weight -> (B, T', C_out), in the weight's
    dtype."""
    out = F.conv1d(x.to(w.dtype).transpose(1, 2), w.permute(2, 1, 0),
                   stride=stride, padding=padding, groups=groups)
    out = out.transpose(1, 2)
    return out if b is None else out + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


def split_heads(z: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = z.shape
    return z.reshape(b, t, heads, d // heads).transpose(1, 2)


def attend(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(scores) in float32, cast to v's dtype, times v (B, H, T, hd)
    -> (B, T, H hd)."""
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    o = probs @ v
    b, h, t, hd = o.shape
    return o.transpose(1, 2).reshape(b, t, h * hd)


def scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T in float32, (B, H, T, hd) x2 -> (B, H, T, T)."""
    return q.float() @ k.float().transpose(-1, -2)


def layer(stack, i: int):
    """Layer ``i`` of a tree of stacked (layer-first) leaves."""
    return {k: v[i] for k, v in stack.items()}


def normal(generator: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)
