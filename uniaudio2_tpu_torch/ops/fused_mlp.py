"""Fused SwiGLU MLP half-block (port of `uniaudio2_tpu/ops/fused_mlp.py`).

    out = [residual +] (silu(n(x) @ W1 * s1) * (n(x) @ W2 * s2)) @ W3 * s3

CUDA kernel ``ua2_fused_swiglu`` (``csrc/fused_swiglu.cu``) replaces the
Pallas kernel `fused_swiglu` (uniaudio2_tpu/ops/fused_mlp.py:225) in every
weight form it has: gate / up int8, K-split int4 (per-channel or grouped)
with an int8 or column-packed (per-channel or grouped) down-projection, or
row-interleaved int4 (per-channel or grouped) with an int8 or
row-interleaved down-projection. The Pallas kernel carries an f32
accumulator over I-chunks on a sequential grid; blocks on the GPU run in no
order, so the CUDA version takes two deterministic passes: pass 1 computes
``h = bf16(silu(a) * b)`` (M x I, 16 KB at M = 1 and I = 8192) into device
memory, pass 2 is the W3 GEMV with the s3 scale and the residual. No
atomics, so the sum order is fixed. The Pallas kernel's column-packed
output order ``[low columns ++ pad][high columns ++ pad]`` is its scratch
layout; pass 2 writes the true columns directly.

The plain twin follows the JAX package's composed path (`gpt._mlp_block`):
`quant.matmul` fallback for gate and up (each rounded to ``x.dtype``),
``silu(gate) * up`` rounded once, the W3 fallback, then the residual add.
"""

from __future__ import annotations

import math

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.norms import rms_norm
from uniaudio2_tpu_torch.ops.quant import (
    LAYOUTS, QuantizedLinear, QuantizedLinear4, QuantizedLinear4G,
    QuantizedLinearC4, QuantizedLinearC4G, QuantizedLinearI4,
    QuantizedLinearI4G, check_operand, check_weight, matmul_plain,
)

# the JAX package's mode names, per container
FORMS = {QuantizedLinear: "int8", QuantizedLinear4: "int4",
         QuantizedLinear4G: "int4g", QuantizedLinearC4: "int4c",
         QuantizedLinearC4G: "int4cg", QuantizedLinearI4: "int4i",
         QuantizedLinearI4G: "int4ig"}


def can_fuse(w1, w2, w3, x: torch.Tensor) -> bool:
    """Eligible, as in the JAX package: quantized gate / up of one type,
    a down-projection of their family (interleaved gate / up take an
    interleaved or int8 one, the others a column-packed or int8 one), at
    most 128 rows, K % 256 == 0, unpadded I with I % 256 == 0, whole scale
    groups per nibble half and per 128 rows of W3. Row-major values only."""
    interleaved = isinstance(w1, (QuantizedLinearI4, QuantizedLinearI4G))
    if not isinstance(w1, (QuantizedLinear, QuantizedLinear4,
                           QuantizedLinear4G, QuantizedLinearI4,
                           QuantizedLinearI4G)):
        return False
    if type(w1) is not type(w2):
        return False
    w3_ok = (QuantizedLinear, QuantizedLinearI4, QuantizedLinearI4G) \
        if interleaved else (QuantizedLinear, QuantizedLinearC4,
                             QuantizedLinearC4G)
    if not isinstance(w3, w3_ok):
        return False
    if any(w.values.ndim != 2 for w in (w1, w2, w3)):
        return False
    if math.prod(x.shape[:-1]) > 128:
        return False
    k = x.shape[-1]
    if k % 256:
        return False
    i = w1.scale.shape[-1]
    if w1.values.shape[-1] != i or w2.values.shape[-1] != i:
        return False  # lane-padded I would index pad rows of W3
    w3_rows = i // 2 if isinstance(w3, (QuantizedLinearI4,
                                        QuantizedLinearI4G)) else i
    if w3.values.shape[-2] != w3_rows:
        return False
    if isinstance(w1, QuantizedLinear4G):
        if (k // 2) % (k // w1.scale.shape[-2]):
            return False
    if isinstance(w1, QuantizedLinearI4G):
        if k % w1.scale.shape[-2]:
            return False
    if isinstance(w3, (QuantizedLinearC4G, QuantizedLinearI4G)):
        if i % w3.scale.shape[-2]:
            return False
        if 128 % (i // w3.scale.shape[-2]):
            return False
    return i % 256 == 0


def fused_swiglu_plain(x, w1, w2, w3, *, norm_w=None, norm_eps=1e-5,
                       residual=None):
    hn = x if norm_w is None else rms_norm(x, norm_w, norm_eps)
    gate = matmul_plain(hn, w1)
    up = matmul_plain(hn, w2)
    h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    out = matmul_plain(h, w3)
    return out if residual is None else residual + out


def fused_swiglu(
    x: torch.Tensor,
    w1,
    w2,
    w3,
    *,
    norm_w: "torch.Tensor | None" = None,
    norm_eps: float = 1e-5,
    residual: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """(..., K) -> (..., N) over weights `can_fuse` admits. ``norm_w``
    folds a leading RMSNorm (``x`` is then the un-normed activation);
    ``residual`` (the output's shape) folds the residual add: together, the
    transformer's ``x + mlp(rmsnorm(x))``. One call is one launch of the
    two-pass kernel; ``.forms`` counts launches by "<gate/up>+<down>" form
    ("int4i+int4i", "int4g+int4cg", "int8+int8", ...)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    n = w3.scale.shape[-1]
    res2 = None if residual is None else residual.reshape(-1, n)
    if x.device.type == "cpu":
        out = fused_swiglu_plain(x2, w1, w2, w3, norm_w=norm_w,
                                 norm_eps=norm_eps, residual=res2)
        return out.reshape(*lead, n)
    if type(w1) is not type(w2) \
            or isinstance(w1, (QuantizedLinearC4, QuantizedLinearC4G)) \
            or isinstance(w3, (QuantizedLinear4, QuantizedLinear4G)) \
            or type(w1) not in LAYOUTS or type(w3) not in LAYOUTS:
        raise ValueError(
            f"fused_swiglu: weights {type(w1).__name__}, {type(w2).__name__}, "
            f"{type(w3).__name__}: gate / up are int8, K-split or "
            f"interleaved, down is int8, column-packed or interleaved")
    dev = x.device
    x2 = x2.contiguous()
    m = x2.shape[0]
    check_operand(x2, "x", torch.bfloat16, (m, k), dev)
    i, g12 = check_weight("w1", LAYOUTS[type(w1)], w1.values, w1.scale, k, dev)
    if check_weight("w2", LAYOUTS[type(w2)], w2.values, w2.scale, k,
                    dev) != (i, g12):
        raise ValueError("fused_swiglu: W1 and W2 differ in width or groups")
    _, g3 = check_weight("w3", LAYOUTS[type(w3)], w3.values, w3.scale, i, dev)
    if w1.values.shape[-1] != i or w2.values.shape[-1] != i or i % 64:
        raise ValueError("fused_swiglu: I must be unpadded and 64-aligned")
    if norm_w is not None:
        check_operand(norm_w, "norm_w", torch.bfloat16, (k,), dev)
    if res2 is not None:
        res2 = res2.contiguous()
        check_operand(res2, "residual", torch.bfloat16, (m, n), dev)
    h = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_fused_swiglu(
        _cuda.ptr(x2), _cuda.ptr(w1.values), _cuda.ptr(w1.scale),
        _cuda.ptr(w2.values), _cuda.ptr(w2.scale), _cuda.ptr(w3.values),
        _cuda.ptr(w3.scale), _cuda.ptr(norm_w), _cuda.ptr(res2),
        _cuda.ptr(h), _cuda.ptr(out), m, k, i, n, w3.values.shape[-1],
        LAYOUTS[type(w1)], g12, LAYOUTS[type(w3)], g3, float(norm_eps),
        _cuda.stream_of(x2))
    _cuda.check(err, "ua2_fused_swiglu")
    _cuda.count(fused_swiglu, f"{FORMS[type(w1)]}+{FORMS[type(w3)]}")
    return out.reshape(*lead, n)


_cuda.reset_count(fused_swiglu)
