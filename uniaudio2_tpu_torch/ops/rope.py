"""Rotary position embeddings with Llama-3 frequency adjustment (port of
`uniaudio2_tpu/ops/rope.py`).

The tables are built on the host in float64 numpy, exactly as the JAX
package builds them, then cast to float32; decode steps gather one row.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.config import RoPEAdjustments


@functools.lru_cache(maxsize=32)
def _rope_cache_np(
    seq_len: int,
    n_elem: int,
    base: float,
    adjustments: Optional[RoPEAdjustments],
) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape ``(seq_len, n_elem)``, float64 -> float32."""
    theta = 1.0 / (base ** (np.arange(0, n_elem, 2, dtype=np.float64) / n_elem))
    if adjustments is not None:
        # Llama-3.x smooth low/high frequency interpolation
        wavelen = 2.0 * np.pi / theta
        ratio = adjustments.original_max_seq_len / wavelen
        smooth = (ratio - adjustments.low_freq_factor) / (
            adjustments.high_freq_factor - adjustments.low_freq_factor
        )
        smooth = np.clip(smooth, 0.0, 1.0)
        theta = (1.0 - smooth) * (theta / adjustments.factor) + smooth * theta
    seq_idx = np.arange(seq_len, dtype=np.float64)
    idx_theta = np.outer(seq_idx, theta)
    idx_theta = np.concatenate([idx_theta, idx_theta], axis=-1)
    return (np.cos(idx_theta).astype(np.float32),
            np.sin(idx_theta).astype(np.float32))


def rope_cache(
    seq_len: int,
    n_elem: int,
    base: float = 10000.0,
    adjustments: Optional[RoPEAdjustments] = None,
    device: "torch.device | str" = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = _rope_cache_np(seq_len, n_elem, float(base), adjustments)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., T, head_size) by (T, head_size) tables, half-split
    convention, in float32, cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)
