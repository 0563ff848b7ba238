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
the device. Each block of the kernel loads the index itself and offsets
the stacked base pointers (the card's counterpart of scalar prefetch):
the host neither reads the index nor slices the stack, so one captured
launch with an index the device advances can walk every layer.

Bound: the layer's weight bytes, 12.6 MB at (K, N) = (3072, 8192), 3.8 us
at 3.35 TB/s. The design reuses the tiled instance of row 5's K-split
GEMV (`gemv_int4.cu`, `quant.int4_matmul_tiled`: 64-column tiles, eight
weight rows in flight a warp, f32 sums added in a fixed order) and gives
its bits on every layer's slice; its one addition,
the index load, is one dependent read before the weight stream.

The plain twin is the JAX body's arithmetic: exact f32 products of bf16
activations and integer levels, an f32 sum, the scale, one rounding.
Kernel and twin sum in another order, so they may differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant
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


def int4_stacked_matmul(x: torch.Tensor, stacked, layer) -> torch.Tensor:
    """x (M, K) bf16 @ layer ``layer`` of the stacked K-split int4
    container ``stacked`` (values (L, K/2, N_pad), scale (L, N)) -> (M, N)
    bf16. ``layer`` is a one-element int32 tensor on the card (the kernel
    reads it there); the plain twin for a CPU tensor."""
    values, scale = stacked.values, stacked.scale
    m, k = x.shape
    if values.ndim != 3 or scale.ndim != 2 or values.shape[0] != scale.shape[0] \
            or values.shape[1] * 2 != k or values.shape[2] < scale.shape[1]:
        raise ValueError(f"int4_stacked_matmul: values {tuple(values.shape)} "
                         f"/ scale {tuple(scale.shape)} do not hold a stacked "
                         f"K-split container of K = {k}")
    if x.device.type == "cpu":
        return int4_stacked_matmul_plain(x, stacked, layer)
    dev = x.device
    n_layers, n = scale.shape
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, tuple(values.shape), dev)
    check_operand(scale, "scale", torch.float32, (n_layers, n), dev)
    if not isinstance(layer, torch.Tensor) or layer.numel() != 1:
        raise ValueError("int4_stacked_matmul: layer must be a one-element "
                         "int32 tensor on the card")
    check_operand(layer, "layer", torch.int32, tuple(layer.shape), dev)
    if values.shape[2] % quant.GEMV_TILE_N:
        raise ValueError(f"int4_stacked_matmul: values {tuple(values.shape)} "
                         f"must hold whole {quant.GEMV_TILE_N}-column tiles")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int4_stacked(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(layer),
        _cuda.ptr(out), m, k, n, values.shape[2],
        values.shape[1] * values.shape[2], n, n_layers, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_stacked")
    _cuda.count(int4_stacked_matmul)
    return out


_cuda.reset_count(int4_stacked_matmul)
