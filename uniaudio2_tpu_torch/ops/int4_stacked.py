"""Stacked-layer K-split int4 GEMV with a device-side layer index (row 14
of the TPU kernel table).

CUDA kernel ``ua2_gemv_int4_stacked`` (``csrc/gemv_int4_stacked.cu``)
replaces `kernel` in `run_prefetch` (scripts/profile_scan_slice.py:101-133,
``pallas_call`` at :114), the TPU probe that reads layer ``l`` of a stacked
K-split int4 container with the index delivered by scalar prefetch, so
that no per-layer slice is copied:

    out = ((x[:, :K/2] @ lo(W[l]) + x[:, K/2:] @ hi(W[l])) in f32)
          * scale[l], rounded to bf16

``values`` (L, K/2, N_pad) int8 (low nibble row k, high nibble row
k + K/2), ``scale`` (L, N) f32, ``x`` (M, K) bf16, ``layer`` one int32 on
the device. The kernel is the TMA-ring split-K GEMV of
``csrc/gemv_int4_stream.cuh`` in its default form (`int4_stream.DEFAULT`,
`int4_stream.stream_plan`'s slices) over one tensor map of the whole
stack: the producer thread reads the index on the device and offsets every
box's row by it, the consumers read it for the scale row. The host neither
reads the index nor slices the stack, so one captured launch with an index
the device advances can walk every layer. At M <= 16 every layer gives
`quant.int4_matmul`'s bits on its slice (the split-K kernel's order and
plan). An index outside [0, L) gives NaN.

`int4_stacked_matmul_simt` launches the first design
(``ua2_gemv_int4_stacked_simt``: the tiled instance of row 5's K-split
GEMV, `gemv_int4.cu`, with the index read by each block), the yardstick,
counted on its own; it gives `quant.int4_matmul_tiled`'s bits on every
layer's slice.

Bound: the layer's weight bytes, 12.6 MB at (K, N) = (3072, 8192), 3.8 us
at 3.35 TB/s.

The plain twin is the JAX body's arithmetic: exact f32 products of bf16
activations and integer levels, an f32 sum, the scale, one rounding.
Kernels and twin sum in another order, so they may differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, quant
from uniaudio2_tpu_torch.ops.quant import check_operand


def _layer_of(values: torch.Tensor, layer) -> torch.Tensor:
    """Layer ``layer`` (an int or a one-element index tensor) of a stacked
    tensor, without reading a device index on the host."""
    if isinstance(layer, torch.Tensor):
        return values.index_select(0, layer.reshape(1).long())[0]
    return values[layer]


def int4_stacked_matmul_plain(x: torch.Tensor, stacked, layer) -> torch.Tensor:
    w = quant.QuantizedLinear4(_layer_of(stacked.values, layer),
                               _layer_of(stacked.scale, layer))
    k2 = x.shape[-1] // 2
    lo, hi = quant._unpack4(w.values[:, :w.scale.shape[-1]])
    acc = (torch.matmul(x[:, :k2].float(), lo.float())
           + torch.matmul(x[:, k2:].float(), hi.float()))
    return (acc * w.scale.float()).to(torch.bfloat16)


def _shape_check(name: str, x: torch.Tensor, stacked) -> None:
    """Raise ValueError unless ``stacked`` is a stack of K-split layers of
    x's K."""
    values, scale = stacked.values, stacked.scale
    if x.ndim != 2 or values.ndim != 3 or scale.ndim != 2 \
            or values.shape[0] != scale.shape[0] \
            or values.shape[1] * 2 != x.shape[-1] \
            or values.shape[2] < scale.shape[1]:
        raise ValueError(f"{name}: values {tuple(values.shape)} / scale "
                         f"{tuple(scale.shape)} do not hold a stacked K-split "
                         f"container of K = {x.shape[-1]}")


def _check(name: str, x: torch.Tensor, stacked, layer) -> None:
    """Raise ValueError unless the kernels take these operands (a stack
    `_shape_check` passed): x (M, K) bf16; L (K/2, ldw) int8 layers of
    whole 64-column tiles, contiguous and 16-byte aligned, scale (L, N)
    f32; ``layer`` a one-element int32 tensor; all on x's device. Runs
    before any plan, on any device."""
    values, scale = stacked.values, stacked.scale
    m, k = x.shape
    dev = x.device
    n_layers, n = scale.shape
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, tuple(values.shape), dev)
    check_operand(scale, "scale", torch.float32, (n_layers, n), dev)
    if not isinstance(layer, torch.Tensor) or layer.numel() != 1:
        raise ValueError(f"{name}: layer must be a one-element int32 tensor "
                         f"on the card")
    check_operand(layer, "layer", torch.int32, tuple(layer.shape), dev)
    if values.shape[2] % quant.GEMV_TILE_N:
        raise ValueError(f"{name}: values {tuple(values.shape)} must hold "
                         f"whole {quant.GEMV_TILE_N}-column tiles")
    if dev.type == "cuda" and values.data_ptr() % 16:
        raise ValueError(f"{name}: values must be 16-byte aligned")


def int4_stacked_matmul(x: torch.Tensor, stacked, layer) -> torch.Tensor:
    """x (M, K) bf16 @ layer ``layer`` of the stacked K-split int4
    container ``stacked`` (values (L, K/2, N_pad), scale (L, N)) -> (M, N)
    bf16 on the TMA ring. ``layer`` is a one-element int32 tensor on the
    card (the kernel reads it there); the plain twin for a CPU tensor."""
    name = "int4_stacked_matmul"
    _shape_check(name, x, stacked)
    if x.device.type == "cpu":
        return int4_stacked_matmul_plain(x, stacked, layer)
    _check(name, x, stacked, layer)
    values, scale = stacked.values, stacked.scale
    m, k = x.shape
    n_layers, n = scale.shape
    form = int4_stream.DEFAULT
    splits, span = int4_stream.plan_launch(name, m, k, n, form, x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().ua2_gemv_int4_stacked(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(layer),
        _cuda.ptr(out), m, k, n, values.shape[2], n, n_layers, splits, span,
        _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_stacked")
    _cuda.count(int4_stacked_matmul)
    return out


def int4_stacked_matmul_simt(x: torch.Tensor, stacked, layer) -> torch.Tensor:
    """`int4_stacked_matmul` on the first design (the yardstick), counted
    on its own; the plain twin for a CPU tensor."""
    name = "int4_stacked_matmul_simt"
    _shape_check(name, x, stacked)
    if x.device.type == "cpu":
        return int4_stacked_matmul_plain(x, stacked, layer)
    _check(name, x, stacked, layer)
    values, scale = stacked.values, stacked.scale
    m, k = x.shape
    n_layers, n = scale.shape
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().ua2_gemv_int4_stacked_simt(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(layer),
        _cuda.ptr(out), m, k, n, values.shape[2],
        values.shape[1] * values.shape[2], n, n_layers, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_stacked_simt")
    _cuda.count(int4_stacked_matmul_simt)
    return out


_cuda.reset_count(int4_stacked_matmul)
_cuda.reset_count(int4_stacked_matmul_simt)
