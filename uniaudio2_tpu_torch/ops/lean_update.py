"""Fused per-leaf update of the memory-lean AdamW (`train/lean_opt.py`).

CUDA kernel ``ua2_lean_update`` (``csrc/lean_update.cu``) replaces
`fused_lean_update` (uniaudio2_tpu/ops/lean_update.py:100-184), the JAX
package's Pallas kernel. Per leaf (rank >= 2, last dim C % 256 == 0):

    m    = b1 * (m_q * m_scale) + (1 - b1) * g
    upd  = -lr * ((m * inv_mc) / (a_i * b_j + eps) + wd * p)
    m_q' = round(m / max(m_scale', 1e-30)),  m_scale' = max_256 |m| / 127

where ``a`` (rows) and ``b`` (cols) are the factored second moment's
rsqrt factors, computed by the caller. The Pallas kernel walks (1, tr, 256)
blocks on its grid to bound Mosaic's compile time; the CUDA kernel gives
one warp to each (row, 256-block) instead. Scales keep the JAX wrapper's
public layout, ``shape[:-1] + (C/256,)``.

Rounding. The reference is the Pallas kernel as the JAX package's tests
run it (interpret mode, compiled by XLA for the CPU), and XLA rounds it so:
``m = fma(m_q, b1 * m_scale, (1 - b1) * g)``, ``den = fma(a, b, eps)``,
``upd = -lr * fma(wd, p, (m * inv_mc) / den)`` and ``m_scale' = max|m| *
(1/127)`` (b1 moved onto the per-block scale, products and sums
contracted into FMAs, the division by 127 turned into a product).
`fused_lean_update_plain` computes exactly that in PyTorch (each FMA
rounded once, `_fma`), and the kernel does the same with ``__fmaf_rn``, so
the twin, the kernel and the JAX reference agree to the bit
(``tests/test_torch_lean.py``, ``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.ops import _cuda

QBLOCK = 256          # must equal lean_opt.M_BLOCK
_TILE_ROWS = 1024     # the Pallas kernel's row-tile cap


def tile_sizes(rows: int, cols: int) -> Optional[Tuple[int, int]]:
    """The Pallas kernel's (row tile, QBLOCK), or None for a leaf it cannot
    tile. The CUDA kernel has no row-tile limit, but `adamw_lean` keeps this
    as its routing predicate so that the same leaves take the fused math as
    on the TPU (the fused and unfused chains differ by float
    reassociation)."""
    if cols % QBLOCK != 0:
        return None
    if rows <= _TILE_ROWS:
        return rows, QBLOCK
    tr = _TILE_ROWS
    while tr >= 8:
        if rows % tr == 0:
            return tr, QBLOCK
        tr -= 8
    return None


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak scalar."""
    return float(np.float32(x))


def _geometry(p: torch.Tensor) -> Tuple[int, int, int]:
    shape = p.shape
    if p.ndim < 2 or shape[-1] % QBLOCK:
        raise ValueError(f"fused_lean_update: untileable leaf {tuple(shape)}")
    lead = int(np.prod(shape[:-2], dtype=np.int64)) if p.ndim > 2 else 1
    return lead, shape[-2], shape[-1]


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, as a fused multiply-add rounds it.
    The product of two float32 values is exact in float64; the sum is
    rounded to odd in float64 (the round-to-nearest sum, moved one ulp
    toward the exact value when the two-sum error is not zero and the last
    bit is even), which makes the final rounding to float32 correct (a
    rounding to odd with 2 or more extra bits, Boldo and Melquiond)."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bp = s - zd
    err = (p - bp) + (zd - (s - bp))
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(odd, bits + step, bits).view(torch.float64).float()


_INV127 = float(np.float32(1.0) / np.float32(127.0))
_CHUNK = 1 << 22      # elements of the twin's float64 working set at a time


def fused_lean_update_plain(g, m_q, m_scale, p, a, b, inv_mc, lr, *,
                            b1: float, wd: float, eps: float):
    """The update in PyTorch ops, with the reference's rounding (module
    docstring). ``inv_mc`` and ``lr`` are float32 scalars (floats or 0-dim
    tensors). Works through the leaf a few rows at a time, so its float64
    temporaries stay small at any leaf size."""
    lead, rows, cols = _geometry(p)
    nsb = cols // QBLOCK
    f32 = torch.float32
    dev = p.device
    inv_mc = torch.as_tensor(inv_mc, dtype=f32, device=dev)
    neg_lr = -torch.as_tensor(lr, dtype=f32, device=dev)
    g2, mq2, p2 = (t.reshape(lead * rows, cols) for t in (g, m_q, p))
    ms2, a1 = m_scale.reshape(lead * rows, nsb), a.reshape(lead * rows)
    b2 = b.reshape(lead, cols)
    upd = torch.empty((lead * rows, cols), dtype=p.dtype, device=dev)
    nmq = torch.empty((lead * rows, cols), dtype=torch.int8, device=dev)
    nms = torch.empty((lead * rows, nsb), dtype=f32, device=dev)
    step = max(1, _CHUNK // cols)
    for r0 in range(0, lead * rows, step):
        r1 = min(r0 + step, lead * rows)
        n = r1 - r0
        blocks = (n, nsb, QBLOCK)
        gf = g2[r0:r1].to(f32).reshape(blocks)
        pf = p2[r0:r1].to(f32).reshape(blocks)
        mq = mq2[r0:r1].to(f32).reshape(blocks)
        b1ms = (ms2[r0:r1] * _f32(b1)).reshape(n, nsb, 1).expand(blocks)
        rows_lead = torch.arange(r0, r1, device=dev) // rows
        brow = b2[rows_lead].reshape(blocks)
        acol = a1[r0:r1].reshape(n, 1, 1).expand(blocks)
        m = _fma(mq, b1ms, _f32(1.0 - b1) * gf)
        den = _fma(acol, brow, torch.full_like(gf, _f32(eps)))
        x = _fma(torch.full_like(gf, _f32(wd)), pf, m * inv_mc / den)
        upd[r0:r1] = (neg_lr * x).reshape(n, cols).to(p.dtype)
        ns = m.abs().amax(dim=-1, keepdim=True) * _INV127
        nmq[r0:r1] = torch.round(m / torch.clamp_min(ns, 1e-30)).to(
            torch.int8).reshape(n, cols)
        nms[r0:r1] = ns.reshape(n, nsb)
    return (upd.reshape(p.shape), nmq.reshape(p.shape),
            nms.reshape(p.shape[:-1] + (nsb,)))


def fused_lean_update(g, m_q, m_scale, p, a, b, inv_mc, lr, *,
                      b1: float, wd: float, eps: float):
    """One leaf's fused update. ``g``/``m_q``/``p`` are leaf-shaped,
    ``m_scale`` is shape[:-1] + (C/256,), ``a`` is shape[:-1], ``b`` is
    shape[:-2] + (C,). Returns (upd, new_m_q, new_m_scale) in the same
    layouts. CPU tensors take the twin; CUDA tensors launch the kernel."""
    if p.device.type == "cpu":
        return fused_lean_update_plain(g, m_q, m_scale, p, a, b, inv_mc, lr,
                                       b1=b1, wd=wd, eps=eps)
    lead, rows, cols = _geometry(p)
    nsb = cols // QBLOCK
    dev, dt = p.device, p.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_lean_update: {dt} leaves are not supported")
    for name, x, want, shape in (
            ("g", g, dt, p.shape), ("m_q", m_q, torch.int8, p.shape),
            ("m_scale", m_scale, torch.float32, p.shape[:-1] + (nsb,)),
            ("a", a, torch.float32, p.shape[:-1]),
            ("b", b, torch.float32, p.shape[:-2] + (cols,)), ("p", p, dt, p.shape)):
        if x.device != dev or x.dtype != want or tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"fused_lean_update: {name} is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, expected {want} {tuple(shape)} on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"fused_lean_update: {name} must be contiguous and 16-byte aligned")
    upd = torch.empty_like(p)
    nmq = torch.empty_like(m_q)
    nms = torch.empty_like(m_scale)
    if p.numel() == 0:
        return upd, nmq, nms
    inv_mc = _f32(float(inv_mc))
    neg_lr = -_f32(float(lr))
    err = _cuda.lib().ua2_lean_update(
        _cuda.ptr(g), _cuda.ptr(m_q), _cuda.ptr(m_scale), _cuda.ptr(p),
        _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(upd), _cuda.ptr(nmq),
        _cuda.ptr(nms), ctypes.c_longlong(lead * rows), rows, cols,
        int(dt == torch.bfloat16), _f32(b1), _f32(1.0 - b1), _f32(wd),
        _f32(eps), inv_mc, neg_lr, _cuda.stream_of(p))
    _cuda.check(err, "ua2_lean_update")
    fused_lean_update.launches += 1
    return upd, nmq, nms


fused_lean_update.launches = 0
