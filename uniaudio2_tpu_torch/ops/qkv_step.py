"""Fused QKV decode step: RMSNorm + quantized GEMV + RoPE + q/k/v split
(port of `uniaudio2_tpu/ops/qkv_step.py`).

CUDA kernel ``ua2_qkv_rope`` (``csrc/qkv_rope.cu``) replaces the Pallas
kernel `qkv_rope_step` (uniaudio2_tpu/ops/qkv_step.py:172) in its five
modes: ``int8``, ``int4`` / ``int4g`` (K-split int4, per-channel / grouped
scales) and ``int4i`` / ``int4ig`` (row-interleaved). Up to
`quant.SPLITK_MAX_M` rows (the frame loop) it launches the split-K cluster
kernel of ``csrc/gemv_int4_splitk.cuh`` in its QKV mode, planned as a GEMV
of (H + 2G) hd columns by `quant.gemv_plan` (at most `QKV_MAX_SPLITS`
K-slices): a 64-column tile holds 32
columns of a head and the 32 hd/2 further on, so each RoPE pair meets in
one cluster, which rotates it in f32 after adding the K-slices' partials in
rank order. Above that (a bucket-64 prefill) and in `qkv_rope_step_tiled`
at any M (the yardstick, counted on its own), the first design: one block
a head, the rotation on the f32 head in shared memory.

The plain twin follows the JAX package's composed path, `gpt._qkv` with a
folded norm: `quant.matmul` fallback to ``x.dtype``, split, then
`rope.apply_rope` in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant
from uniaudio2_tpu_torch.ops.quant import (
    LAYOUTS, QuantizedLinear, QuantizedLinear4, QuantizedLinear4G,
    QuantizedLinearI4, QuantizedLinearI4G, check_operand, check_weight,
    matmul_plain,
)
from uniaudio2_tpu_torch.ops.rope import apply_rope

HEAD_SIZES = (64, 128)   # the kernel's instantiations (decoder, backbone)
# The most K-slices of the QKV mode's plan (`quant.gemv_plan` caps its
# slice count here, below the GEMV's `quant.SPLITK_MAX_SPLITS`): every
# block of a cluster runs the norm prologue over all of K, so more slices
# add prologue work where they shorten the walk over W. At each of the 40
# cases of `probes/qkv_splits_sweep.py` (five modes, both widths, M = 1, 2,
# 8, 16; an H100) 4 slices were the fastest or within 1.1 % of it; the
# uncapped plan took 6 at the decoder (to 1.10x the fastest) and 8 for
# int4g there (1.41-1.57x).
QKV_MAX_SPLITS = 4
# the JAX package's mode names, per container
MODES = {QuantizedLinear: "int8", QuantizedLinear4: "int4",
         QuantizedLinear4G: "int4g", QuantizedLinearI4: "int4i",
         QuantizedLinearI4G: "int4ig"}


def can_fuse(w, x: torch.Tensor, n_head: int, n_groups: int,
             head_size: int) -> bool:
    """Eligible, as in the JAX package without its chunk rules (a tile
    here holds whole RoPE pairs of one head, whatever the width): a
    row-major quantized weight
    of one of `MODES`, exactly (H + 2G) * hd unpadded columns, single-token
    rows B <= 128, K % 256 == 0, whole scale groups per nibble half."""
    if type(w) not in MODES or w.values.ndim != 2:
        return False
    if x.ndim != 2 or x.shape[0] > 128:
        return False
    k = x.shape[-1]
    if k % 256 or head_size not in HEAD_SIZES:
        return False
    n = (n_head + 2 * n_groups) * head_size
    if w.scale.shape[-1] != n or w.values.shape[-1] != n:
        return False                                  # lane-padded storage
    if isinstance(w, QuantizedLinear4G):
        if (k // 2) % (k // w.scale.shape[-2]):
            return False
    if isinstance(w, QuantizedLinearI4G):
        if k % w.scale.shape[-2]:
            return False
    return True


def qkv_rope_step_plain(x, w, norm_w, norm_eps, cos, sin, n_head, n_groups,
                        head_size):
    b = x.shape[0]
    hd = head_size
    qkv = matmul_plain(x, w, pre_norm=(norm_w, norm_eps))
    q = qkv[:, : n_head * hd].reshape(b, n_head, hd)
    k = qkv[:, n_head * hd: (n_head + n_groups) * hd].reshape(b, n_groups, hd)
    v = qkv[:, (n_head + n_groups) * hd:]
    q = apply_rope(q, cos, sin).reshape(b, -1)
    k = apply_rope(k, cos, sin).reshape(b, -1)
    return q, k, v


def _launch(c_name, x, w, norm_w, norm_eps, cos, sin, n_head, n_groups,
            head_size, planned=False):
    """Validate the operands and launch the C entry point ``c_name``, given
    `quant.gemv_plan`'s (splits, span) before the stream when ``planned``
    (the tiled kernel above `quant.SPLITK_MAX_M` rows reads neither);
    returns q, k, v."""
    dev = x.device
    b, k = x.shape
    hd = head_size
    n = (n_head + 2 * n_groups) * hd
    if hd not in HEAD_SIZES:
        raise ValueError(f"qkv_rope_step: head_size {hd} not in {HEAD_SIZES}")
    if type(w) not in MODES:
        raise ValueError(f"qkv_rope_step: weight {type(w).__name__}")
    check_operand(x, "x", torch.bfloat16, (b, k), dev)
    n_w, g = check_weight("qkv_w", LAYOUTS[type(w)], w.values, w.scale, k, dev)
    if n_w != n or w.values.shape[-1] != n:
        raise ValueError(f"qkv_rope_step: weight width {n_w} (stored "
                         f"{w.values.shape[-1]}) != (H + 2G) * hd = {n}")
    check_operand(norm_w, "norm_w", torch.bfloat16, (k,), dev)
    check_operand(cos, "cos", torch.float32, (hd,), dev)
    check_operand(sin, "sin", torch.float32, (hd,), dev)
    plan = ()
    if planned:
        if w.values.data_ptr() % 16:
            raise ValueError("qkv_rope_step: values must be 16-byte aligned")
        p = quant.gemv_plan(b, k, n, g, LAYOUTS[type(w)], quant._sm_count(dev),
                            QKV_MAX_SPLITS)
        plan = (p.splits, p.span)
    q = torch.empty((b, n_head * hd), dtype=x.dtype, device=dev)
    k_out = torch.empty((b, n_groups * hd), dtype=x.dtype, device=dev)
    v_out = torch.empty((b, n_groups * hd), dtype=x.dtype, device=dev)
    err = getattr(_cuda.lib(), c_name)(
        _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale),
        _cuda.ptr(norm_w), _cuda.ptr(cos), _cuda.ptr(sin), _cuda.ptr(q),
        _cuda.ptr(k_out), _cuda.ptr(v_out), b, k, n_head, n_groups, hd,
        LAYOUTS[type(w)], g, float(norm_eps), *plan, _cuda.stream_of(x))
    _cuda.check(err, c_name)
    return q, k_out, v_out


def qkv_rope_step(
    x: torch.Tensor,
    w,
    norm_w: torch.Tensor,
    norm_eps: float,
    cos: torch.Tensor,
    sin: torch.Tensor,
    n_head: int,
    n_groups: int,
    head_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (B, K) un-normed -> roped ``q`` (B, H*hd), roped ``k``
    (B, G*hd), raw ``v`` (B, G*hd), all in ``x.dtype``. ``cos``/``sin`` are
    the (hd,) f32 rope rows of the step position, shared by the batch.
    ``w`` is any container of `MODES`. Up to `quant.SPLITK_MAX_M` rows the
    split-K kernel's QKV mode as `quant.gemv_plan` says (N = (H + 2G) hd,
    at most `QKV_MAX_SPLITS` K-slices), above them the first design; the
    plain twin for CPU tensors.
    ``.forms`` counts launches by mode."""
    if x.device.type == "cpu":
        return qkv_rope_step_plain(x, w, norm_w, norm_eps, cos, sin, n_head,
                                   n_groups, head_size)
    out = _launch("ua2_qkv_rope", x, w, norm_w, norm_eps, cos, sin, n_head,
                  n_groups, head_size, planned=True)
    _cuda.count(qkv_rope_step, MODES[type(w)])
    return out


def qkv_rope_step_tiled(x, w, norm_w, norm_eps, cos, sin, n_head, n_groups,
                        head_size):
    """`qkv_rope_step` through the first design (one block a head,
    ``ua2_qkv_rope_tiled``) at any M, counted on its own by mode. No
    serving path calls it: it is the yardstick the split-K kernel is timed
    against."""
    if x.device.type == "cpu":
        return qkv_rope_step_plain(x, w, norm_w, norm_eps, cos, sin, n_head,
                                   n_groups, head_size)
    out = _launch("ua2_qkv_rope_tiled", x, w, norm_w, norm_eps, cos, sin,
                  n_head, n_groups, head_size)
    _cuda.count(qkv_rope_step_tiled, MODES[type(w)])
    return out


_cuda.reset_count(qkv_rope_step)
_cuda.reset_count(qkv_rope_step_tiled)
