"""Row-interleaved int4 GEMV with a conversion-free unpack (row 11 of the
TPU kernel table).

CUDA kernel ``ua2_gemv_int4_native`` (``csrc/gemv_int4_native.cu``)
replaces `int4_native_matmul` (scripts/int4_native_probe.py:43-84), the TPU
probe that handed the i4 -> bf16 unpack of row 1's GEMV to the hardware:
``x (M, K) bf16 @ W (K, N) * scale (N,)``, an f32 sum, one rounding to
bf16. W is int8 bytes of row-interleaved nibbles (row 2r low, 2r+1 high,
levels -8..7), row-major ``(K/2, ldw)`` or chunk-major ``(C, K/2, bn)``.
On the H100 the kernel is the TMA-ring split-K GEMV of
``csrc/gemv_int4_stream.cuh`` in its default form (`int4_stream.DEFAULT`,
`quant.gemv_plan`'s slices): at M <= 16 it gives `quant.int4i_matmul`'s
bits (the split-K kernel's) on the same bytes, in both byte orders.

`int4_native_matmul_simt` launches the first design
(``ua2_gemv_int4_native_simt``, `gemv_int4_probe.cuh`: CUDA-core FMAs in
the order of `gemv_int4i.cu`'s tiled instance, whose bits it gives), the
yardstick, counted on its own.

The plain twin rounds as the Pallas kernel does in interpret mode: exact
f32 products of bf16 activations and integer levels, an f32 sum, the
scale, one rounding. Kernel and twin sum in another order, so they may
differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, quant
from uniaudio2_tpu_torch.ops.quant import _unchunk_values, check_operand

TILE = 64           # output columns a block of the first design (COLS 2)


def int4_native_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    levels = quant.levels(quant.QuantizedLinearI4(_unchunk_values(values),
                                                  scale))
    acc = torch.matmul(x.float(), levels.float())
    return (acc * scale.float()).to(torch.bfloat16)


def _width(values: torch.Tensor) -> int:
    return values.shape[0] * values.shape[2] if values.ndim == 3 \
        else values.shape[1]


def _check_shape(name: str, x, values, scale) -> None:
    k, n = x.shape[-1], scale.shape[-1]
    if values.ndim not in (2, 3) or values.shape[-2] * 2 != k \
            or _width(values) < n:
        raise ValueError(f"{name}: values {tuple(values.shape)} do not hold "
                         f"K = {k}, N = {n}")


def int4_native_matmul(x: torch.Tensor, values: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ interleaved int4 bytes * scale (N,) -> (M, N) bf16
    on the TMA-ring split-K kernel; the plain twin for a CPU tensor."""
    _check_shape("int4_native_matmul", x, values, scale)
    if x.device.type == "cpu":
        return int4_native_matmul_plain(x, values, scale)
    form = int4_stream.DEFAULT
    ldw, bn = int4_stream.check_operands("int4_native_matmul", x, values,
                                         scale, form)
    m, k = x.shape
    n = scale.shape[-1]
    splits, span = int4_stream.plan_launch("int4_native_matmul", m, k, n,
                                           form, x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().ua2_gemv_int4_native(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(out),
        m, k, n, ldw, bn, splits, span, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_native")
    _cuda.count(int4_native_matmul)
    return out


def int4_native_matmul_simt(x: torch.Tensor, values: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """`int4_native_matmul` on the first design (the yardstick), counted on
    its own; the plain twin for a CPU tensor."""
    _check_shape("int4_native_matmul_simt", x, values, scale)
    if x.device.type == "cpu":
        return int4_native_matmul_plain(x, values, scale)
    m, k = x.shape
    n = scale.shape[-1]
    dev = x.device
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, tuple(values.shape), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    bn = values.shape[2] if values.ndim == 3 else 0
    ldw = 0 if bn else values.shape[1]
    if (bn % TILE) if bn else (-(-n // TILE) * TILE > ldw):
        raise ValueError(f"int4_native_matmul_simt: values "
                         f"{tuple(values.shape)} must hold whole {TILE}-column "
                         f"tiles")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int4_native_simt(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(out),
        m, k, n, ldw, bn, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_native_simt")
    _cuda.count(int4_native_matmul_simt)
    return out


_cuda.reset_count(int4_native_matmul)
_cuda.reset_count(int4_native_matmul_simt)
