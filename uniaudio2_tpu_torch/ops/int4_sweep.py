"""The K-split int4 GEMV in twelve tile forms (row 13 of the TPU kernel
table).

CUDA kernel ``ua2_gemv_int4_sweep`` (``csrc/gemv_int4_sweep.cu``) replaces
`matmul_bn` (scripts/sweep_gemv_blocks.py:37-75), the TPU probe that swept
the tile width and unpack width of row 5's K-split GEMV: ``(x[:, :K/2] @
lo + x[:, K/2:] @ hi) * scale`` over (K/2, ldw) bytes, byte [r, c] = row r
(low nibble) and row r + K/2 (high nibble). On the H100 a form is (byte
columns a lane loads, weight rows in flight, activation rows a block
reuses, unpack): `FORMS`, in the C table's order. Form 0 is the tiled
instance of `gemv_int4.cu` (`quant.int4_matmul_tiled`) and gives its bits.

The plain twin is the Pallas kernel's arithmetic in interpret mode: two
f32 products over the K halves, added, the scale, one rounding to bf16.
The kernel adds the two halves row by row, so the two may differ by one
bf16 ulp.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.quant import _unpack4, check_operand


class Form(NamedTuple):
    cols: int       # byte columns a lane loads: a block owns 32 * cols
    unroll: int     # weight rows a warp has in flight
    mt: int         # activation rows a block stages and reuses
    unpack: str     # "shift" or "magic"

    @property
    def name(self) -> str:
        return f"c{self.cols}u{self.unroll}mt{self.mt}-{self.unpack}"


FORMS = tuple(Form(*f) for f in (
    (2, 8, 4, "shift"), (2, 8, 4, "magic"), (4, 8, 4, "shift"),
    (4, 8, 4, "magic"), (2, 4, 4, "shift"), (2, 16, 4, "shift"),
    (2, 8, 8, "shift"), (2, 8, 16, "shift"), (2, 8, 8, "magic"),
    (2, 8, 16, "magic"), (4, 8, 16, "magic"), (2, 16, 16, "magic")))
PRODUCTION = 0      # the form of gemv_int4.cu


def check_forms() -> None:
    """Raise unless the library's form table is `FORMS`, in order."""
    got, params = [], (ctypes.c_int * 4)()
    while True:
        n = _cuda.lib().ua2_gemv_int4_sweep_form(len(got), params)
        if n < 0:
            break
        c, u, mt, unpack = params
        got.append(Form(c, u, mt, ("shift", "magic")[unpack]))
    if tuple(got) != FORMS:
        raise RuntimeError(f"csrc/gemv_int4_sweep.cu forms {got} != {FORMS}")


def int4_sweep_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    n = scale.shape[-1]
    k2 = values.shape[0]
    lo, hi = _unpack4(values[:, :n])
    acc = (torch.matmul(x[:, :k2].float(), lo.float())
           + torch.matmul(x[:, k2:].float(), hi.float()))
    return (acc * scale.float()).to(torch.bfloat16)


def int4_sweep_matmul(x: torch.Tensor, values: torch.Tensor,
                      scale: torch.Tensor, form: int = PRODUCTION
                      ) -> torch.Tensor:
    """x (M, K) bf16 @ K-split int4 (K/2, ldw) * scale (N,) -> (M, N) bf16
    in tile form ``FORMS[form]``; the plain twin for a CPU tensor.
    ``.forms`` counts the launches of each form by name."""
    m, k = x.shape
    n = scale.shape[-1]
    f = FORMS[form]
    if values.ndim != 2 or values.shape[0] * 2 != k or values.shape[1] < n:
        raise ValueError(f"int4_sweep_matmul: values {tuple(values.shape)} "
                         f"do not hold K = {k}, N = {n}")
    if x.device.type == "cpu":
        return int4_sweep_matmul_plain(x, values, scale)
    dev = x.device
    ldw = values.shape[1]
    tile = 32 * f.cols
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, (k // 2, ldw), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    if -(-n // tile) * tile > ldw:
        raise ValueError(f"int4_sweep_matmul: rows of {ldw} bytes do not hold "
                         f"whole {tile}-column tiles of N = {n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_gemv_int4_sweep(
        form, _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale),
        _cuda.ptr(out), m, k, n, ldw, _cuda.stream_of(x))
    _cuda.check(err, "ua2_gemv_int4_sweep")
    _cuda.count(int4_sweep_matmul, f.name)
    return out


_cuda.reset_count(int4_sweep_matmul)
