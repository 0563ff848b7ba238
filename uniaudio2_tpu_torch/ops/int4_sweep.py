"""The K-split int4 GEMV in twelve forms (row 13 of the TPU kernel table).

CUDA kernel ``ua2_gemv_int4_sweep`` (``csrc/gemv_int4_sweep.cu``) replaces
`matmul_bn` (scripts/sweep_gemv_blocks.py:37-75), the TPU probe that swept
the tile width and unpack width of row 5's K-split GEMV: ``(x[:, :K/2] @
lo + x[:, K/2:] @ hi) * scale`` over (K/2, ldw) bytes, byte [r, c] = row r
(low nibble) and row r + K/2 (high nibble). On the H100 a form is a point
of the TMA-ring split-K GEMV's own parameters (``csrc/gemv_int4_stream.cuh``;
`int4_stream.StreamForm`: tile width, box rows, ring stages, slice rule,
unpack): `FORMS`, in the C table's order. Form 0 is row 11's default form
with `quant.gemv_plan`'s slices and gives the split-K kernel's bits
(`quant.int4_matmul` at M <= 16).

`int4_sweep_matmul_simt` launches the first design's forms (`SIMT_FORMS`:
``gemv_int4_probe.cuh``, CUDA-core FMAs; its form 0 gives the tiled
instance of `gemv_int4.cu` its bits), the yardstick, counted on its own.

The plain twin is the Pallas kernel's arithmetic in interpret mode: two
f32 products over the K halves, added, the scale, one rounding to bf16.
The kernels sum in another order, so the two may differ by one bf16 ulp.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from uniaudio2_tpu_torch.ops import _cuda, int4_stream
from uniaudio2_tpu_torch.ops.int4_stream import StreamForm
from uniaudio2_tpu_torch.ops.quant import _unpack4, check_operand

FORMS = tuple(StreamForm(*f) for f in (
    (64, 64, 4, "plan", "magic"), (64, 64, 4, "plan", "shift"),
    (64, 32, 4, "plan", "magic"), (64, 32, 8, "plan", "magic"),
    (64, 128, 4, "plan", "magic"), (64, 64, 2, "plan", "magic"),
    (64, 64, 8, "plan", "magic"), (128, 64, 4, "plan", "magic"),
    (128, 64, 8, "plan", "magic"), (64, 64, 4, "one", "magic"),
    (64, 64, 4, "double", "magic"), (128, 64, 4, "plan", "shift")))
PRODUCTION = 0      # row 11's default form: the split-K kernel's bits


class SimtForm(NamedTuple):
    cols: int       # byte columns a lane loads: a block owns 32 * cols
    unroll: int     # weight rows a warp has in flight
    mt: int         # activation rows a block stages and reuses
    unpack: str     # "shift" or "magic"

    @property
    def name(self) -> str:
        return f"c{self.cols}u{self.unroll}mt{self.mt}-{self.unpack}"


# the first design's form 0 (gemv_int4.cu's tiled instance), COLS 4 in both
# unpacks (the fastest at M = 16) and UNROLL 16 (the fastest at M = 1)
SIMT_FORMS = tuple(SimtForm(*f) for f in (
    (2, 8, 4, "shift"), (4, 8, 4, "shift"), (4, 8, 4, "magic"),
    (2, 16, 4, "shift")))


def _table(fn_name: str, width: int) -> list:
    got, params = [], (ctypes.c_int * width)()
    while getattr(_cuda.lib(), fn_name)(len(got), params) >= 0:
        got.append(tuple(params))
    return got


def check_forms() -> None:
    """Raise unless the library's form tables are `FORMS` and `SIMT_FORMS`,
    in order, and row 11's form is `int4_stream.DEFAULT` = form 0."""
    got = _table("ua2_gemv_int4_sweep_form", 5)
    if got != [f.params for f in FORMS]:
        raise RuntimeError(f"csrc/gemv_int4_sweep.cu forms {got} != "
                           f"{[f.params for f in FORMS]}")
    simt = [SimtForm(c, u, mt, int4_stream.UNPACKS[p])
            for c, u, mt, p in _table("ua2_gemv_int4_sweep_simt_form", 4)]
    if tuple(simt) != SIMT_FORMS:
        raise RuntimeError(f"csrc/gemv_int4_sweep.cu first-design forms "
                           f"{simt} != {SIMT_FORMS}")
    native = (ctypes.c_int * 5)()
    _cuda.lib().ua2_gemv_int4_native_form(native)
    if tuple(native) != int4_stream.DEFAULT.params \
            or FORMS[PRODUCTION] != int4_stream.DEFAULT:
        raise RuntimeError(f"csrc/gemv_int4_native.cu form {tuple(native)} "
                           f"!= {int4_stream.DEFAULT.params}")


def int4_sweep_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    n = scale.shape[-1]
    k2 = values.shape[0]
    lo, hi = _unpack4(values[:, :n])
    acc = (torch.matmul(x[:, :k2].float(), lo.float())
           + torch.matmul(x[:, k2:].float(), hi.float()))
    return (acc * scale.float()).to(torch.bfloat16)


def _check_shape(name: str, x, values, scale) -> None:
    k, n = x.shape[-1], scale.shape[-1]
    if values.ndim != 2 or values.shape[0] * 2 != k or values.shape[1] < n:
        raise ValueError(f"{name}: values {tuple(values.shape)} do not hold "
                         f"K = {k}, N = {n}")


def int4_sweep_matmul(x: torch.Tensor, values: torch.Tensor,
                      scale: torch.Tensor, form: int = PRODUCTION
                      ) -> torch.Tensor:
    """x (M, K) bf16 @ K-split int4 (K/2, ldw) * scale (N,) -> (M, N) bf16
    on the TMA-ring split-K kernel in ``FORMS[form]``; the plain twin for a
    CPU tensor. ``.forms`` counts the launches of each form by name."""
    f = FORMS[form]
    _check_shape("int4_sweep_matmul", x, values, scale)
    if x.device.type == "cpu":
        return int4_sweep_matmul_plain(x, values, scale)
    ldw, _ = int4_stream.check_operands("int4_sweep_matmul", x, values,
                                        scale, f)
    m, k = x.shape
    n = scale.shape[-1]
    splits, span = int4_stream.plan_launch("int4_sweep_matmul", m, k, n, f,
                                           x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _cuda.lib().ua2_gemv_int4_sweep(
        form, _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale),
        _cuda.ptr(out), m, k, n, ldw, splits, span, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_sweep")
    _cuda.count(int4_sweep_matmul, f.name)
    return out


def int4_sweep_matmul_simt(x: torch.Tensor, values: torch.Tensor,
                           scale: torch.Tensor, form: int = 0
                           ) -> torch.Tensor:
    """`int4_sweep_matmul` on the first design in ``SIMT_FORMS[form]`` (the
    yardstick), counted on its own by form name; the plain twin for a CPU
    tensor."""
    f = SIMT_FORMS[form]
    _check_shape("int4_sweep_matmul_simt", x, values, scale)
    if x.device.type == "cpu":
        return int4_sweep_matmul_plain(x, values, scale)
    m, k = x.shape
    n = scale.shape[-1]
    dev = x.device
    ldw = values.shape[1]
    tile = 32 * f.cols
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, (k // 2, ldw), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    if -(-n // tile) * tile > ldw:
        raise ValueError(f"int4_sweep_matmul_simt: rows of {ldw} bytes do not "
                         f"hold whole {tile}-column tiles of N = {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int4_sweep_simt(
        form, _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale),
        _cuda.ptr(out), m, k, n, ldw, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_sweep_simt")
    _cuda.count(int4_sweep_matmul_simt, f.name)
    return out


_cuda.reset_count(int4_sweep_matmul)
_cuda.reset_count(int4_sweep_matmul_simt)
