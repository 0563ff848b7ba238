"""Row-interleaved int4 GEMV with a conversion-free unpack (row 11 of the
TPU kernel table).

CUDA kernel ``ua2_gemv_int4_native`` (``csrc/gemv_int4_native.cu``)
replaces `int4_native_matmul` (scripts/int4_native_probe.py:43-84), the TPU
probe that handed the i4 -> bf16 unpack of row 1's GEMV to the hardware:
``x (M, K) bf16 @ W (K, N) * scale (N,)``, an f32 sum, one rounding to
bf16. W is int8 bytes of row-interleaved nibbles (row 2r low, 2r+1 high,
levels -8..7), row-major ``(K/2, ldw)`` or chunk-major ``(C, K/2, bn)``.
On the H100 the kernel is `gemv_int4i.cu`'s with the magic-number unpack,
and gives its bits on the same bytes.

The plain twin rounds as the Pallas kernel does in interpret mode: exact
f32 products of bf16 activations and integer levels, an f32 sum, the
scale, one rounding. Kernel and twin sum in another order, so they may
differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant
from uniaudio2_tpu_torch.ops.quant import _unchunk_values, check_operand

TILE = 64           # output columns a block owns (COLS 2)


def int4_native_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    levels = quant.levels(quant.QuantizedLinearI4(_unchunk_values(values),
                                                  scale))
    acc = torch.matmul(x.float(), levels.float())
    return (acc * scale.float()).to(torch.bfloat16)


def _width(values: torch.Tensor) -> int:
    return values.shape[0] * values.shape[2] if values.ndim == 3 \
        else values.shape[1]


def int4_native_matmul(x: torch.Tensor, values: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ interleaved int4 bytes * scale (N,) -> (M, N) bf16;
    the plain twin for a CPU tensor."""
    m, k = x.shape
    n = scale.shape[-1]
    rows = values.shape[-2]
    if values.ndim not in (2, 3) or rows * 2 != k or _width(values) < n:
        raise ValueError(f"int4_native_matmul: values {tuple(values.shape)} "
                         f"do not hold K = {k}, N = {n}")
    if x.device.type == "cpu":
        return int4_native_matmul_plain(x, values, scale)
    dev = x.device
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, tuple(values.shape), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    bn = values.shape[2] if values.ndim == 3 else 0
    ldw = 0 if bn else values.shape[1]
    if (bn % TILE) if bn else (-(-n // TILE) * TILE > ldw):
        raise ValueError(f"int4_native_matmul: values {tuple(values.shape)} "
                         f"must hold whole {TILE}-column tiles")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int4_native(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(out),
        m, k, n, ldw, bn, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_native")
    _cuda.count(int4_native_matmul)
    return out


_cuda.reset_count(int4_native_matmul)
