"""Batch-1 int8 GEMV as a multiply and a K-reduction, split over K.

CUDA kernel ``ua2_gemv_int8_splitk`` (``csrc/gemv_int8_splitk.cu``)
replaces `vpu_gemv` (scripts/profile_gemv.py:65-98), the TPU probe that
computes the production int8 GEMV on the vector unit: ``(1, K) @ W int8
(K, N_pad)``, each product exact, summed in f32, times the per-column scale,
rounded to bf16 and trimmed to N. On the H100 it asks whether an M = 1 int8
GEMV can fill the 132 SMs: the rows of K are split over blocks (`plan`), the
f32 partials added in a fixed order by a second pass.

The plain twin `int8_splitk_gemv_plain` rounds as the interpret-mode Pallas
kernel does: exact f32 products (XLA keeps the bf16 product of an int8 level
and a bf16 activation in f32), an f32 sum, one rounding after the scale.
Kernel and twin sum in another order, so they may differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.quant import check_operand

SMS = 132               # streaming multiprocessors of an H100 SXM
TILE = 128              # output columns a block owns
LANES = 32              # row lanes a block (the chunk is a multiple of it)
BLOCKS_PER_SM = 4       # the grid's depth: at least this many blocks an SM


def plan(k: int, n: int):
    """(splits, chunk): K rows cut into ``splits`` chunks of ``chunk`` rows,
    a multiple of 32, so that the grid of ceil(N / 128) column tiles x
    splits has at least four blocks for each SM (or as many splits as 32-row
    chunks allow)."""
    tiles = -(-n // TILE)
    want = max(1, -(-BLOCKS_PER_SM * SMS // tiles))
    chunk = max(LANES, -(-k // want) // LANES * LANES)
    return -(-k // chunk), chunk


def int8_splitk_gemv_plain(x: torch.Tensor, values: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    n = scale.shape[-1]
    acc = (values[:, :n].float() * x.float().reshape(-1, 1)).sum(dim=0)
    return (acc * scale.float()).to(x.dtype).reshape(1, n)


def int8_splitk_gemv(x: torch.Tensor, values: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x (1, K) bf16 @ int8 values (K, N_pad) * scale (N,) -> (1, N) bf16."""
    if x.device.type == "cpu":
        return int8_splitk_gemv_plain(x, values, scale)
    k, ldw = values.shape
    n = scale.shape[-1]
    dev = x.device
    check_operand(x, "x", torch.bfloat16, (1, k), dev)
    check_operand(values, "values", torch.int8, (k, ldw), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    if ldw < n or ldw % 16 or values.data_ptr() % 16:
        raise ValueError(f"int8_splitk_gemv: values (K, {ldw}) must hold N = {n} "
                         f"columns in rows of 16-byte multiples, 16-byte aligned")
    splits, chunk = plan(k, n)
    partial = torch.empty((splits, -(-n // TILE) * TILE), dtype=torch.float32,
                          device=dev)
    out = torch.empty((1, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int8_splitk(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(partial),
        _cuda.ptr(out), k, n, ldw, splits, chunk, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int8_splitk")
    _cuda.count(int8_splitk_gemv)
    return out


_cuda.reset_count(int8_splitk_gemv)
