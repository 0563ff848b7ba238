"""Non-causal softmax attention for the codec DiT.

CUDA kernel ``ua2_flash_attn`` (``csrc/flash_attn.cu``) replaces
`_flash_attention` (uniaudio2_tpu/codec/dit.py:174-193), the JAX package's
call of JAX's Pallas TPU ``flash_attention``. It computes the same function
at every T: keys past T are masked inside the kernel, so nothing is padded
(the JAX call pads T to 128 and masks with segment ids; its T >= 128 gate
is a TPU tuning choice, and its try/except fallback is not copied).

The plain twin `attention_plain` follows the JAX einsum path
(`dit.py:218-223`): f32 scores x hd^-0.5, f32 softmax, probabilities cast
to ``v.dtype``, then P.V. The kernel rounds the *unnormalised* P to bf16
and divides by the row sum at the end (the flash convention); in bf16 the
two agree to about 2^-8 of the output's range, so the card-side check is
|kernel - twin| <= 2e-2 x max|twin|, as for the GEMV kernels.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.quant import check_operand

HEAD_DIMS = (64, 128)   # the kernel's instantiations


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``q``, ``k``, ``v`` (B, H, T, hd) -> (B, H, T, hd) in ``q.dtype``:
    softmax(q k^T * scale) v over all T keys, per (batch, head)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    b, h, t, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(x, name, torch.bfloat16, (b, h, t, hd), dev)
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    o = torch.empty_like(q)
    if t == 0:
        return o
    err = _cuda.lib().ua2_flash_attn(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), b * h, t, hd,
        float(scale), _cuda.stream_of(q))
    _cuda.check(err, "ua2_flash_attn")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
