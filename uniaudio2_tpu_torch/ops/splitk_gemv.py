"""Batch-1 int8 GEMV split over K (row 12 of the TPU kernel table).

CUDA kernel ``ua2_gemv_int8_splitk`` (``csrc/gemv_int8_splitk.cu``)
replaces `vpu_gemv` (scripts/profile_gemv.py:65-98), the TPU probe that
computes the production int8 GEMV on the vector unit: ``(1, K) @ W int8
(K, N_pad)``, each product exact, summed in f32, times the per-column scale,
rounded to bf16 and trimmed to N. On the H100 it asks whether an M = 1 int8
GEMV can fill the 132 SMs and reach the memory's rate.

The kernel is the TMA-ring split-K GEMV of ``csrc/gemv_int4_stream.cuh``
in its int8 form: one launch, the weight bytes by TMA into a ring, the
split-K kernel's INT8 steps on the tensor cores, the K-slices of a column
tile one cluster whose partials are added in rank order. `FORM` is its
one form (`int4_stream.StreamForm`, ``bk`` in pairs of rows: a box of 128
byte rows), the C source's ``namespace ring``, chosen by the (3072, 8192)
time among eight. On `quant.gemv_plan`'s slices it gives
`quant.int8_matmul`'s bits (the split-K kernel's). K must be a multiple
of 16 (the ring's steps).

`int8_splitk_gemv_twopass` launches the first design
(``ua2_gemv_int8_splitk_twopass``: CUDA-core FMAs, the rows of K cut by
`plan`, an f32 workspace added up by a second pass), the yardstick,
counted on its own.

The plain twin `int8_splitk_gemv_plain` rounds as the interpret-mode Pallas
kernel does: exact f32 products (XLA keeps the bf16 product of an int8 level
and a bf16 activation in f32), an f32 sum, one rounding after the scale.
Kernels and twin sum in another order, so they may differ by one bf16 ulp.
"""

from __future__ import annotations

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream, quant
from uniaudio2_tpu_torch.ops.int4_stream import StreamForm
from uniaudio2_tpu_torch.ops.quant import check_operand

SMS = 132               # streaming multiprocessors of an H100 SXM
TILE = 128              # output columns a block of the first design owns
LANES = 32              # row lanes a block (the chunk is a multiple of it)
BLOCKS_PER_SM = 4       # the grid's depth: at least this many blocks an SM

INT8 = quant.LAYOUT_INT8
FORM = StreamForm(64, 64, 4, "plan", "magic")


def plan(k: int, n: int):
    """The first design's (splits, chunk): K rows cut into ``splits``
    chunks of ``chunk`` rows, a multiple of 32, so that the grid of
    ceil(N / 128) column tiles x splits has at least four blocks for each
    SM (or as many splits as 32-row chunks allow)."""
    tiles = -(-n // TILE)
    want = max(1, -(-BLOCKS_PER_SM * SMS // tiles))
    chunk = max(LANES, -(-k // want) // LANES * LANES)
    return -(-k // chunk), chunk


def int8_splitk_gemv_plain(x: torch.Tensor, values: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    n = scale.shape[-1]
    acc = (values[:, :n].float() * x.float().reshape(-1, 1)).sum(dim=0)
    return (acc * scale.float()).to(x.dtype).reshape(1, n)


def _check_shape(name: str, x, values, scale) -> None:
    if values.ndim != 2 or x.ndim != 2 or x.shape[0] != 1 \
            or values.shape[0] != x.shape[1] \
            or values.shape[1] < scale.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ values "
                         f"{tuple(values.shape)} is not (1, K) @ (K, N_pad) "
                         f"for N = {scale.shape[-1]}")


def int8_splitk_gemv(x: torch.Tensor, values: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x (1, K) bf16 @ int8 values (K, N_pad) * scale (N,) -> (1, N) bf16
    on the TMA ring; the plain twin for a CPU tensor."""
    _check_shape("int8_splitk_gemv", x, values, scale)
    if x.device.type == "cpu":
        return int8_splitk_gemv_plain(x, values, scale)
    ldw, _ = int4_stream.check_operands("int8_splitk_gemv", x, values, scale,
                                        FORM, INT8)
    m, k = x.shape
    n = scale.shape[-1]
    splits, span = int4_stream.plan_launch("int8_splitk_gemv", m, k, n,
                                           FORM, x.device, INT8)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().ua2_gemv_int8_splitk(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(out), m,
        k, n, ldw, splits, span, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int8_splitk")
    _cuda.count(int8_splitk_gemv)
    return out


def int8_splitk_gemv_twopass(x: torch.Tensor, values: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """`int8_splitk_gemv` on the first design (the yardstick), counted on
    its own; the plain twin for a CPU tensor."""
    _check_shape("int8_splitk_gemv_twopass", x, values, scale)
    if x.device.type == "cpu":
        return int8_splitk_gemv_plain(x, values, scale)
    k, ldw = values.shape
    n = scale.shape[-1]
    dev = x.device
    check_operand(x, "x", torch.bfloat16, (1, k), dev)
    check_operand(values, "values", torch.int8, (k, ldw), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    if ldw < n or ldw % 16 or values.data_ptr() % 16:
        raise ValueError(f"int8_splitk_gemv_twopass: values (K, {ldw}) must "
                         f"hold N = {n} columns in rows of 16-byte multiples, "
                         f"16-byte aligned")
    splits, chunk = plan(k, n)
    partial = torch.empty((splits, -(-n // TILE) * TILE), dtype=torch.float32,
                          device=dev)
    out = torch.empty((1, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int8_splitk_twopass(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(partial),
        _cuda.ptr(out), k, n, ldw, splits, chunk, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int8_splitk_twopass")
    _cuda.count(int8_splitk_gemv_twopass)
    return out


_cuda.reset_count(int8_splitk_gemv)
_cuda.reset_count(int8_splitk_gemv_twopass)
