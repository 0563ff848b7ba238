"""Conditional flow matching: the Euler solver (port of
`uniaudio2_tpu/codec/cfm.py`).

Fixed-step Euler integration from noise (t = 0) to data (t = 1). Before
every step the in-context prefix of ``x`` is re-noised onto the straight
path ``(1 - (1 - sigma) t) z + t x_ctx``; with guidance > 1 the estimator
runs a batch-doubled CFG pass whose unconditioned half has the condition
channels zeroed. The solver state is f32 whatever the estimator's dtype.

The noise ``z`` is an argument: JAX draws it from a threefry key, which
torch cannot reproduce, so the caller (`decoder.CodecDecoder`) draws it
from a seeded ``torch.Generator``, or a test hands in JAX's own draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

SIGMA_MIN = 1e-4

# Estimator signature: (x_cat (B, T, C_in), t (B,)) -> velocity (B, T, C_out)
Estimator = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _time_grid(num_steps: int) -> np.ndarray:
    """``jnp.linspace(0, 1, num_steps + 1)`` in f32, bit for bit: i times the
    f32 reciprocal of n (XLA turns the division by a constant into that
    product), then the endpoint 1."""
    step = np.float32(1.0) / np.float32(num_steps)
    return np.append(np.arange(num_steps, dtype=np.float32) * step,
                     np.float32(1.0))


def solve_euler(
    estimator: Estimator,
    *,
    noise: torch.Tensor,           # (B, T, C_lat)
    mu: torch.Tensor,              # (B, T, C_cond) conditioning features
    incontext_x: torch.Tensor,     # (B, T, C_lat) in-context latents
    incontext_mask: torch.Tensor,  # (B, T) bool, True where in-context
    num_steps: int,
    guidance_scale: float,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Returns the solved latents (B, T, C_lat) f32, the in-context frames
    clamped back to ``incontext_x``."""
    b = mu.shape[0]
    mu = mu.float()
    incontext_x = incontext_x.float()
    noise = noise.float() * temperature
    ctx = incontext_mask[..., None]
    ts = torch.from_numpy(_time_grid(num_steps))
    use_cfg = guidance_scale > 1.0
    if use_cfg:
        ctx2 = torch.cat([incontext_x, incontext_x], 0)
        mu2 = torch.cat([torch.zeros_like(mu), mu], 0)
    x = noise
    for i in range(num_steps):
        t, dt = ts[i], ts[i + 1] - ts[i]       # f32 scalars, as in JAX
        tb = torch.full((b,), float(t), dtype=torch.float32, device=mu.device)
        path = (1.0 - (1.0 - SIGMA_MIN) * t) * noise + t * incontext_x
        x = torch.where(ctx, path, x)
        if use_cfg:
            inp = torch.cat([torch.cat([x, x], 0), ctx2, mu2], dim=-1)
            v_uncond, v_cond = estimator(inp, torch.cat([tb, tb], 0)).chunk(2, 0)
            v = v_uncond + guidance_scale * (v_cond - v_uncond)
        else:
            v = estimator(torch.cat([x, incontext_x, mu], dim=-1), tb)
        x = x + dt * v
    return torch.where(ctx, incontext_x, x)


def loss(*args, **kwargs):
    raise NotImplementedError(
        "cfm.loss is not ported yet (ROADMAP queue 1 item 17, codec training)")
