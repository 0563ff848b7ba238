"""Softmax attention: non-causal for the codec DiT, causal with grouped K/V
heads for the backbone's prefill probe.

CUDA kernels ``ua2_flash_attn`` (``csrc/flash_attn.cu``, bf16: wgmma
products, K/V through a TMA ring, the launch planned on the host by
`flash_plan`) and ``ua2_flash_attn_f32`` (``csrc/flash_attn_f32.cu``,
float32, non-causal: both products on the tensor cores as three TF32
products, hi.hi + hi.lo + lo.hi, at float32 accuracy; the first design,
f32 FMAs on the CUDA cores, stays as `flash_attention_f32_simt`, the
yardstick) replace
`_flash_attention` (uniaudio2_tpu/codec/dit.py:174-193), the JAX
package's call of JAX's Pallas TPU ``flash_attention``, and `bb_flash`
(scripts/profile_attention.py:102-108), the same bundled kernel with
``causal=True`` over K/V repeated from G groups to H heads. It computes the
same function at every T: keys past T are masked inside the kernel, so
nothing is padded (the JAX call pads T to 128 and masks with segment ids;
its T >= 128 gate is a TPU tuning choice, and its try/except fallback is
not copied). Head h reads K/V group h / (H / G) in place, the function of
JAX's ``jnp.repeat``.

The plain twin `attention_plain` follows the JAX einsum path
(`dit.py:218-223`): f32 scores x scale, masked past each row when causal,
f32 softmax, probabilities cast to ``v.dtype``, then P.V. The kernel rounds
the *unnormalised* P to bf16 and divides by the row sum at the end (the
flash convention); in bf16 the two agree to about 2^-8 of the output's
range, so the card-side check is |kernel - twin| <= 2e-2 x max|twin|, as
for the GEMV kernels. In float32 both keep every product and probability
in f32 (the kernel's products to ~22 bits of each operand) and differ in
the order of the sums.

The backbone's own prefill keeps `ops.attention.causal_attention`: the JAX
engine's prefill runs that XLA einsum, not a Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.quant import check_operand

HEAD_DIMS = (64, 128)   # the kernels' instantiations
DTYPES = (torch.bfloat16, torch.float32)   # flash_attn.cu, flash_attn_f32.cu


class FlashPlan(NamedTuple):
    """How one `flash_attention` call is launched: ``bq`` query rows a
    block, ``tiles`` query tiles a (batch, head), ``blocks`` in the grid."""

    bq: int
    tiles: int
    blocks: int


@functools.lru_cache(maxsize=None)
def flash_plan(b: int, h: int, g: int, t: int, hd: int) -> FlashPlan:
    """The launch of one call: a block of one 64-row consumer warpgroup at
    hd 64 (small enough that two or three blocks share an SM), two sharing
    each staged K/V tile at hd 128. ``g`` (K/V groups) does not change the
    grid: the heads of a group read its K/V in place. The kernel's stages
    and shared memory are its own (`ua2_flash_layout`)."""
    if hd not in HEAD_DIMS or t < 1 or g <= 0 or h % g:
        raise ValueError(f"flash_plan: no launch for H = {h}, G = {g}, "
                         f"T = {t}, hd = {hd}")
    bq = hd
    tiles = -(-t // bq)
    return FlashPlan(bq, tiles, b * h * tiles)


def flash_layout(hd: int, bq: int) -> tuple[int, int, int]:
    """The built kernel's (keys a K/V stage, stages in the ring, bytes of
    dynamic shared memory a block) for ``bq`` query rows at head dim
    ``hd``."""
    out = (ctypes.c_int * 3)()
    _cuda.check(_cuda.lib().ua2_flash_layout(hd, bq, out), "ua2_flash_layout")
    return tuple(out)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    h, g = q.shape[1], k.shape[1]
    if g != h:      # the JAX probe's jnp.repeat of each group to its heads
        k, v = (x.repeat_interleave(h // g, dim=1) for x in (k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[2]
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _operands(fn, q, k, v, dtypes):
    """(B, H, G, T, hd) of card operands a flash kernel takes; raises for
    any other head dim, dtype, head grouping, shape or alignment."""
    b, h, t, hd = q.shape
    g = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in dtypes:
        raise ValueError(f"{fn}: dtype {q.dtype} not in {dtypes}")
    if g <= 0 or h % g:
        raise ValueError(f"{fn}: {h} heads over {g} K/V groups")
    for name, x, heads in (("q", q, h), ("k", k, g), ("v", v, g)):
        check_operand(x, name, q.dtype, (b, heads, t, hd), q.device)
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    return b, h, g, t, hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """``q`` (B, H, T, hd), ``k``, ``v`` (B, G, T, hd) with H % G == 0 ->
    (B, H, T, hd) in ``q.dtype``: softmax(q k^T * scale) v per (batch,
    head) over all T keys, or keys up to each query's own position when
    ``causal``. bf16 launches ``ua2_flash_attn``, float32 (non-causal
    only: the DiT is its one caller) ``ua2_flash_attn_f32``, counted as
    the form "f32"."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    if causal and q.dtype == torch.float32:
        raise ValueError("flash_attention: the float32 kernel is non-causal")
    b, h, g, t, hd = _operands("flash_attention", q, k, v, DTYPES)
    o = torch.empty_like(q)
    if t == 0:
        return o
    args = (_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), b, h, g, t,
            hd, float(scale))
    if q.dtype == torch.float32:
        err = _cuda.lib().ua2_flash_attn_f32(*args, _cuda.stream_of(q))
        _cuda.check(err, "ua2_flash_attn_f32")
        form = "f32"
    else:
        plan = flash_plan(b, h, g, t, hd)
        err = _cuda.lib().ua2_flash_attn(*args, int(causal), plan.bq,
                                         _cuda.stream_of(q))
        _cuda.check(err, "ua2_flash_attn")
        form = "causal" if causal else None
    _cuda.count(flash_attention, form)
    return o


def flash_attention_f32_simt(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float) -> torch.Tensor:
    """`flash_attention` of float32 inputs (non-causal) through the first
    design, f32 FMAs on the CUDA cores (``ua2_flash_attn_f32_simt``),
    counted on its own. No path of the model calls it: it is the yardstick
    the 3xTF32 kernel is timed against."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    b, h, g, t, hd = _operands("flash_attention_f32_simt", q, k, v,
                               (torch.float32,))
    o = torch.empty_like(q)
    if t == 0:
        return o
    err = _cuda.lib().ua2_flash_attn_f32_simt(
        _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o), b, h, g, t,
        hd, float(scale), _cuda.stream_of(q))
    _cuda.check(err, "ua2_flash_attn_f32_simt")
    _cuda.count(flash_attention_f32_simt)
    return o


_cuda.reset_count(flash_attention)
_cuda.reset_count(flash_attention_f32_simt)
