"""Memory-lean AdamW for single-card training (port of
`uniaudio2_tpu/train/lean_opt.py`).

`adamw_lean` keeps AdamW's update shape with about one byte of state per
parameter:

* first moment: int8, block-quantized with an absmax scale per 256 values
  along the last axis (one scale per last-axis row when the last axis is
  not a multiple of 256);
* second moment: factored row / column means of g**2 (Adafactor's rank-1
  reconstruction) for every rank >= 2 leaf; rank-1 leaves keep an exact
  float32 second moment;
* Adam bias corrections on both moments; decoupled weight decay.

Leaves are updated one after another, so the float32 temporaries are one
leaf's at a time (the JAX package needs `optimization_barrier` for that;
eager PyTorch does it by construction).

On the card every factored, block-divisible leaf that the Pallas kernel's
`tile_sizes` admits goes through `ops.lean_update.fused_lean_update`, the
CUDA kernel: exactly the leaves the JAX package sends to its Pallas
kernel. On the CPU ``fused="on"`` sends the same leaves through the
kernel's twin, and ``"auto"`` / ``"off"`` through the plain chain. The
second-moment EMA and the rsqrt factors ``a_row`` / ``b_col`` stay plain
PyTorch. Every other leaf takes the plain chain.

On a mesh (DTensor leaves) each leaf's update runs on the gathered leaf
(`optim.leaf_whole`): the blocks and the factored moments span the whole
leaf, and a per-shard factored moment would be other math. The gathered
leaf is whole, which is all the kernel asks, so it takes the kernel on
the card whatever the mesh's size, as a leaf without a mesh does. (The
JAX package turns its kernel off on a mesh of more than one device
because its SPMD partitioner cannot shard a ``pallas_call``; the port
gathers the leaf itself.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from uniaudio2_tpu_torch.ops import lean_update as _lu
from uniaudio2_tpu_torch.train.optim import (
    GradientTransformation, Schedule, leaf_whole, place_state, tree_map,
)

M_BLOCK = 256


class _FactoredV(NamedTuple):
    """Factored second moment of one rank >= 2 leaf: means of g**2 over the
    last axis (``row``, shape[:-1]) and the second-to-last axis (``col``,
    shape[:-2] + shape[-1:])."""
    row: torch.Tensor
    col: torch.Tensor


class _LeafState(NamedTuple):
    m_q: torch.Tensor                   # int8, leaf shape
    m_scale: torch.Tensor               # f32, shape[:-1] + (C/256,) or shape[:-1]
    v: Any                              # _FactoredV (rank >= 2) or f32 leaf


class AdamWLeanState(NamedTuple):
    count: int                          # step counter
    leaves: Any                         # tree of _LeafState, like the params


def _m_blocks(shape) -> Optional[Tuple[int, ...]]:
    """Blocked view of a leaf for moment quantization (M_BLOCK-wide blocks
    along the last axis), or None when the last axis is not divisible."""
    if len(shape) and shape[-1] % M_BLOCK == 0:
        return tuple(shape[:-1]) + (shape[-1] // M_BLOCK, M_BLOCK)
    return None


def _quant_m(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-absmax int8 quantization of the first moment."""
    x = m.float()
    blocks = _m_blocks(m.shape)
    if blocks is None:
        scale = x.abs() / 127.0 if m.ndim == 0 else x.abs().amax(dim=-1) / 127.0
        den = torch.clamp_min(scale[..., None] if m.ndim else scale, 1e-30)
        return torch.round(x / den).to(torch.int8), scale
    xb = x.reshape(blocks)
    scale = xb.abs().amax(dim=-1) / 127.0
    q = torch.round(xb / torch.clamp_min(scale[..., None], 1e-30))
    return q.to(torch.int8).reshape(m.shape), scale


def _dequant_m(m_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x = m_q.float()
    blocks = _m_blocks(m_q.shape)
    if blocks is None:
        return x * scale if m_q.ndim == 0 else x * scale[..., None]
    return (x.reshape(blocks) * scale[..., None]).reshape(m_q.shape)


def _v_init(p: torch.Tensor, device):
    if p.ndim >= 2:
        return _FactoredV(
            row=torch.zeros(p.shape[:-1], dtype=torch.float32, device=device),
            col=torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                            device=device))
    return torch.zeros(p.shape, dtype=torch.float32, device=device)


def _v_update(v, g2: torch.Tensor, b2: float):
    if isinstance(v, _FactoredV):
        return _FactoredV(
            row=b2 * v.row + (1.0 - b2) * g2.mean(dim=-1),
            col=b2 * v.col + (1.0 - b2) * g2.mean(dim=-2))
    return b2 * v + (1.0 - b2) * g2


def _v_rsqrt(v, bias_corr: float, eps: float) -> torch.Tensor:
    """1 / (sqrt(v_hat) + eps), broadcastable to the leaf."""
    if isinstance(v, _FactoredV):
        row_mean = v.row.mean(dim=-1, keepdim=True)
        vhat = (v.row[..., :, None] * v.col[..., None, :]
                / torch.clamp_min(row_mean[..., None], 1e-30)) / bias_corr
        return 1.0 / (torch.sqrt(vhat) + eps)
    return 1.0 / (torch.sqrt(v / bias_corr) + eps)


def _resolve_fused(fused: str) -> str:
    """"on", "off" or "auto". On the card every leaf that `fused_leaf`
    admits takes the lean kernel, whatever the mode ("off" there raises);
    on the CPU "on" takes the kernel's twin and "auto" / "off" the plain
    chain, as the JAX package's "auto" is off on the CPU."""
    if fused not in ("on", "off", "auto"):
        raise ValueError(f"adamw_lean fused={fused!r}: expected on/off/auto")
    return fused


def fused_leaf(p: torch.Tensor, s: _LeafState) -> bool:
    """Whether a leaf takes the fused update (`lean_opt.py:235-237`)."""
    return (isinstance(s.v, _FactoredV) and _m_blocks(p.shape) is not None
            and _lu.tile_sizes(p.shape[-2], p.shape[-1]) is not None)


def step_scalars(count: int, learning_rate, b1: float, b2: float
                 ) -> Tuple[float, float, float, float]:
    """(mc, vc, inv_mc, lr) of step ``count`` (1-based), each a float32
    value: the bias corrections ``1 - b**t``, ``1 / mc`` and the rate."""
    t = np.float32(count)
    mc = np.float32(1.0) - np.float32(b1) ** t
    vc = np.float32(1.0) - np.float32(b2) ** t
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return float(mc), float(vc), float(np.float32(1.0) / mc), float(np.float32(lr))


def fused_inputs(g: torch.Tensor, s: _LeafState, vc: float, b2: float):
    """The second-moment EMA of a fused leaf and the kernel's rsqrt
    factors: (v, a_row, b_col) with ``a_i * b_j = sqrt(v_hat_ij)``."""
    v = _v_update(s.v, g.float().square(), b2)
    rm = torch.clamp_min(v.row.mean(dim=-1, keepdim=True), 1e-30)
    return v, torch.sqrt(v.row / (rm * vc)), torch.sqrt(v.col)


def adamw_lean(learning_rate: Union[float, Schedule], *, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.01,
               fused: str = "auto") -> GradientTransformation:
    """AdamW with an int8 first moment and a factored second moment. The
    schedule is read at the step count after this update (1 at the first
    step), as the JAX package reads it."""
    mode = _resolve_fused(fused)

    def init(params, device="cuda"):
        def leaf(p):
            m_q, m_scale = _quant_m(torch.zeros(p.shape, device=device))
            return place_state(_LeafState(m_q=m_q, m_scale=m_scale,
                                          v=_v_init(p, device)), p)
        return AdamWLeanState(count=0, leaves=tree_map(leaf, params))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("adamw_lean requires params (weight decay)")
        count = state.count + 1
        mc, vc, inv_mc, lr = step_scalars(count, learning_rate, b1, b2)

        def leaf(g, s, p):
            fused_ok = fused_leaf(p, s)
            if fused_ok and p.is_cuda and mode == "off":
                raise ValueError(
                    "adamw_lean fused='off' is for CPU leaves: on the card "
                    "every leaf that fused_leaf admits takes the lean kernel")
            if fused_ok and (p.is_cuda or mode == "on"):
                v, a_row, b_col = fused_inputs(g, s, vc, b2)
                upd, m_q, m_scale = _lu.fused_lean_update(
                    g.contiguous(), s.m_q, s.m_scale, p, a_row, b_col, inv_mc,
                    lr, b1=b1, wd=weight_decay, eps=eps)
                return upd, _LeafState(m_q=m_q, m_scale=m_scale, v=v)
            gf = g.float()
            m = b1 * _dequant_m(s.m_q, s.m_scale) + (1.0 - b1) * gf
            v = _v_update(s.v, gf.square(), b2)
            upd = (m / mc) * _v_rsqrt(v, vc, eps)
            upd = upd + weight_decay * p.float()
            upd = (-lr * upd).to(p.dtype)
            m_q, m_scale = _quant_m(m)
            return upd, _LeafState(m_q=m_q, m_scale=m_scale, v=v)

        pairs = tree_map(lambda g, s, p: leaf_whole(leaf, g, s, p), updates,
                         state.leaves, params)
        return (tree_map(lambda pair: pair[0], pairs),
                AdamWLeanState(count=count,
                               leaves=tree_map(lambda pair: pair[1], pairs)))

    return GradientTransformation(init, update)


def state_bytes(state) -> int:
    """Total optimizer-state bytes (for memory accounting)."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0
    return walk(state)
