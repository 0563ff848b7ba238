"""Fused SwiGLU MLP half-block (port of `uniaudio2_tpu/ops/fused_mlp.py`).

    out = [residual +] (silu(n(x) @ W1 * s1) * (n(x) @ W2 * s2)) @ W3 * s3

CUDA entry point ``ua2_fused_swiglu`` (``csrc/fused_swiglu.cu``) replaces
the Pallas kernel `fused_swiglu` (uniaudio2_tpu/ops/fused_mlp.py:225) in
every weight form it has: gate / up int8, K-split int4 (per-channel or
grouped) with an int8 or column-packed (per-channel or grouped)
down-projection, or row-interleaved int4 (per-channel or grouped) with an
int8 or row-interleaved down-projection. The Pallas kernel carries an f32
accumulator over I-chunks on a sequential grid; blocks on the GPU run in no
order, so the CUDA version takes two deterministic passes, as
`swiglu_plan` says: pass 1 computes a = n(x) W1 s1 and b = n(x) W2 s2 in
f32 into a workspace (M x 2I, 64 KB at M = 1 and I = 8192), pass 2 is the
W3 GEMV over h = bf16(silu(a) * b) with the s3 scale and the residual. Up
to 16 rows (the frame loop) both passes are the split-K cluster kernel of
``csrc/gemv_int4_splitk.cuh``, pass 2 staging h itself; above that (the
bucket-64 prefill's 63 or 126 rows) ``ua2_fused_swiglu_tc``, two launches
of the tensor-core tile kernel of ``csrc/gemv_int4_tc.cuh``: pass 1 its
instance of its own (``swiglu_tc_kernel``, W1's and W2's columns side by
side in a block, writing h; the K-split layout read in x's k order, so it
sums what the interleaved layout sums in the same order), pass 2 the
served tile GEMV of W3's layout over h. `fused_swiglu_tiled` launches the
first design's two tiled passes at any M, the yardstick. No atomics, so
the sum order is fixed by the plan; a K-split tree and its interleaved
copy (the same levels) get the same bits above 16 rows. The Pallas
kernel's column-packed output order ``[low columns ++ pad][high columns
++ pad]`` is its scratch layout; pass 2 writes the true columns
directly.

The plain twin follows the JAX package's composed path (`gpt._mlp_block`):
`quant.matmul` fallback for gate and up (each rounded to ``x.dtype``),
``silu(gate) * up`` rounded once, the W3 fallback, then the residual add.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from uniaudio2_tpu_torch.ops import _cuda, quant
from uniaudio2_tpu_torch.ops.norms import rms_norm
from uniaudio2_tpu_torch.ops.quant import (
    LAYOUT_C4, LAYOUT_I4, LAYOUTS, QuantizedLinear,
    QuantizedLinear4, QuantizedLinear4G, QuantizedLinearC4,
    QuantizedLinearC4G, QuantizedLinearI4, QuantizedLinearI4G, check_operand,
    check_weight, matmul_plain,
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
    groups per nibble half and per 128 rows of W3; besides, a column-packed
    grouped W3 whose groups are whole steps of 16 rows, the split-K pass 2
    reading a step's rows under one scale (the JAX package fuses groups of
    2-8 rows too; here such a tree takes the unfused GEMVs), and above
    `quant.SPLITK_MAX_M` rows grouped gate / up and down whose groups are
    whole k-steps of 16 rows, which the tile passes read under one scale
    (the JAX package fuses smaller ones; here they take the unfused
    GEMVs). Row-major values only."""
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
    if isinstance(w3, QuantizedLinearC4G) and (i // w3.scale.shape[-2]) % 16:
        return False
    if math.prod(x.shape[:-1]) > quant.SPLITK_MAX_M and not _tile_groups(
            k, w1.scale.shape[-2] if w1.scale.ndim == 2 else 0,
            i, w3.scale.shape[-2] if w3.scale.ndim == 2 else 0):
        return False
    return i % 256 == 0


def _tile_groups(k: int, g12: int, i: int, g3: int) -> bool:
    """Whether the tile passes take these scale groups (0: per channel):
    each a whole number of k-steps of 16 rows."""
    return not (g12 and (k // g12) % 16) and not (g3 and (i // g3) % 16)


def fused_swiglu_plain(x, w1, w2, w3, *, norm_w=None, norm_eps=1e-5,
                       residual=None):
    hn = x if norm_w is None else rms_norm(x, norm_w, norm_eps)
    gate = matmul_plain(hn, w1)
    up = matmul_plain(hn, w2)
    h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    out = matmul_plain(h, w3)
    return out if residual is None else residual + out


class SwigluPlan(NamedTuple):
    """How one fused SwiGLU call is launched. ``kind`` "splitk" (up to
    `quant.SPLITK_MAX_M` rows: the split-K kernel twice, ``up`` and
    ``down`` `quant.GemvPlan`s of pass 1 over W1 | W2 and pass 2 over W3)
    or "tile" (above: the tile kernel twice, ``up`` and ``down``
    `quant.TcPlan`s)."""

    kind: str
    up: tuple
    down: tuple


@functools.lru_cache(maxsize=None)
def swiglu_plan(m: int, k: int, i: int, n: int, g12: int, layout12: int,
                g3: int, layout3: int, sms: int) -> SwigluPlan:
    """The launch of `fused_swiglu` of ``m`` rows, K = ``k``, I = ``i``,
    N = ``n``, gate / up of layout ``layout12`` with ``g12`` scale groups,
    down of ``layout3`` with ``g3`` (0: per channel), on ``sms`` SMs: a
    function of the shape and the SM count only. Up to `SPLITK_MAX_M` rows
    `quant.gemv_plan` of pass 1 (n = 2 I: W1's column tiles, then W2's)
    and of pass 2; raises for a column-packed W3 with groups of fewer than
    16 rows (a step of 16 rows must lie in one group; `can_fuse` refuses
    them). Above that the tile passes: pass 1 takes the interleaved
    layout's `quant.tc_plan` over 2 I columns (UP_COLS of W1 and of W2 a
    block) in every layout, so that a K-split gate / up sums over the same
    K-slices as its interleaved copy; pass 2 W3's `quant.tc_plan`, equal
    for the column-packed and interleaved layouts at an even N. Raises for
    groups that are not whole k-steps of 16 rows (`can_fuse` refuses
    them)."""
    if m > quant.SPLITK_MAX_M:
        if not _tile_groups(k, g12, i, g3):
            raise ValueError(f"fused_swiglu: groups of {k // max(g12, 1)} / "
                             f"{i // max(g3, 1)} rows; the tile passes take "
                             f"whole k-steps of 16")
        return SwigluPlan("tile",
                          quant.tc_plan(m, k, 2 * i, g12, sms, LAYOUT_I4),
                          quant.tc_plan(m, i, n, g3, sms, layout3))
    if g3 and layout3 == LAYOUT_C4 and (i // g3) % 16:
        raise ValueError(f"fused_swiglu: W3 groups of {i // g3} rows; the "
                         f"split-K kernel takes whole steps of 16")
    return SwigluPlan("splitk",
                      quant.gemv_plan(m, k, 2 * i, g12, layout12, sms),
                      quant.gemv_plan(m, i, n, g3, layout3, sms))


def _twin(x, w1, w2, w3, norm_w, norm_eps, residual):
    """`fused_swiglu_plain` over the leading axes of a CPU call."""
    k, n = x.shape[-1], w3.scale.shape[-1]
    res2 = None if residual is None else residual.reshape(-1, n)
    out = fused_swiglu_plain(x.reshape(-1, k), w1, w2, w3, norm_w=norm_w,
                             norm_eps=norm_eps, residual=res2)
    return out.reshape(*x.shape[:-1], n)


def _operands(name, x, w1, w2, w3, norm_w, residual):
    """Validate a card call; returns (x2, res2, m, k, i, n, g12, g3)."""
    if type(w1) is not type(w2) \
            or isinstance(w1, (QuantizedLinearC4, QuantizedLinearC4G)) \
            or isinstance(w3, (QuantizedLinear4, QuantizedLinear4G)) \
            or type(w1) not in LAYOUTS or type(w3) not in LAYOUTS:
        raise ValueError(
            f"{name}: weights {type(w1).__name__}, {type(w2).__name__}, "
            f"{type(w3).__name__}: gate / up are int8, K-split or "
            f"interleaved, down is int8, column-packed or interleaved")
    dev = x.device
    k = x.shape[-1]
    n = w3.scale.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    check_operand(x2, "x", torch.bfloat16, (m, k), dev)
    i, g12 = check_weight("w1", LAYOUTS[type(w1)], w1.values, w1.scale, k, dev)
    if check_weight("w2", LAYOUTS[type(w2)], w2.values, w2.scale, k,
                    dev) != (i, g12):
        raise ValueError(f"{name}: W1 and W2 differ in width or groups")
    _, g3 = check_weight("w3", LAYOUTS[type(w3)], w3.values, w3.scale, i, dev)
    if w1.values.shape[-1] != i or w2.values.shape[-1] != i or i % 64:
        raise ValueError(f"{name}: I must be unpadded and 64-aligned")
    if norm_w is not None:
        check_operand(norm_w, "norm_w", torch.bfloat16, (k,), dev)
    res2 = None
    if residual is not None:
        res2 = residual.reshape(-1, n).contiguous()
        check_operand(res2, "residual", torch.bfloat16, (m, n), dev)
    return x2, res2, m, k, i, n, g12, g3


def _tiled(x2, w1, w2, w3, norm_w, norm_eps, res2):
    """One launch of the two tiled passes (``ua2_fused_swiglu_tiled``) on
    operands `_operands` has checked."""
    m, k = x2.shape
    i, n = w1.scale.shape[-1], w3.scale.shape[-1]
    g12, g3 = (w.scale.shape[0] if w.scale.ndim == 2 else 0 for w in (w1, w3))
    h = torch.empty((m, i), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = _cuda.lib().ua2_fused_swiglu_tiled(
        _cuda.ptr(x2), _cuda.ptr(w1.values), _cuda.ptr(w1.scale),
        _cuda.ptr(w2.values), _cuda.ptr(w2.scale), _cuda.ptr(w3.values),
        _cuda.ptr(w3.scale), _cuda.ptr(norm_w), _cuda.ptr(res2),
        _cuda.ptr(h), _cuda.ptr(out), m, k, i, n, w3.values.shape[-1],
        LAYOUTS[type(w1)], g12, LAYOUTS[type(w3)], g3, float(norm_eps),
        _cuda.stream_of(x2))
    _cuda.check(err, "ua2_fused_swiglu_tiled")
    return out


def _passes(x2, w1, w2, w3, norm_w, norm_eps, res2, plan):
    """One call of ``ua2_fused_swiglu`` (the two split-K passes) with the
    "splitk" `SwigluPlan` ``plan``, on operands `_operands` has checked;
    the workspace from ``torch.empty``."""
    dev = x2.device
    m, k = x2.shape
    i, n = w1.scale.shape[-1], w3.scale.shape[-1]
    if any(t.data_ptr() % 16 for t in (x2, w1.values, w2.values, w3.values)):
        raise ValueError("fused_swiglu: x and the weights must be 16-byte "
                         "aligned")
    ab = torch.empty((m, 2 * i), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_fused_swiglu(
        _cuda.ptr(x2), _cuda.ptr(w1.values), _cuda.ptr(w1.scale),
        _cuda.ptr(w2.values), _cuda.ptr(w2.scale), _cuda.ptr(w3.values),
        _cuda.ptr(w3.scale), _cuda.ptr(norm_w), _cuda.ptr(res2),
        _cuda.ptr(ab), _cuda.ptr(out), m, k, i, n, w3.values.shape[-1],
        LAYOUTS[type(w1)], w1.scale.shape[0] if w1.scale.ndim == 2 else 0,
        LAYOUTS[type(w3)], w3.scale.shape[0] if w3.scale.ndim == 2 else 0,
        float(norm_eps), plan.up.splits, plan.up.span, plan.down.splits,
        plan.down.span, _cuda.stream_of(x2))
    _cuda.check(err, "ua2_fused_swiglu")
    return out


def _tile_passes(x2, w1, w2, w3, norm_w, norm_eps, res2, plan):
    """One call of ``ua2_fused_swiglu_tc`` (the two tile passes) with the
    "tile" `SwigluPlan` ``plan``, on operands `_operands` has checked;
    returns the output and h, pass 1's (M, I) bf16 workspace."""
    dev = x2.device
    m, k = x2.shape
    i, n = w1.scale.shape[-1], w3.scale.shape[-1]
    if any(t.data_ptr() % 16 for t in (x2, w1.values, w2.values, w3.values)):
        raise ValueError("fused_swiglu: x and the weights must be 16-byte "
                         "aligned")
    xn = None if norm_w is None else torch.empty_like(x2)
    h = torch.empty((m, i), dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _cuda.lib().ua2_fused_swiglu_tc(
        _cuda.ptr(x2), _cuda.ptr(w1.values), _cuda.ptr(w1.scale),
        _cuda.ptr(w2.values), _cuda.ptr(w2.scale), _cuda.ptr(w3.values),
        _cuda.ptr(w3.scale), _cuda.ptr(norm_w), _cuda.ptr(res2),
        _cuda.ptr(xn), _cuda.ptr(h), _cuda.ptr(out), m, k, i, n,
        w3.values.shape[-1],
        LAYOUTS[type(w1)], w1.scale.shape[0] if w1.scale.ndim == 2 else 0,
        LAYOUTS[type(w3)], w3.scale.shape[0] if w3.scale.ndim == 2 else 0,
        float(norm_eps), plan.up.splits, plan.up.span, plan.down.splits,
        plan.down.span, _cuda.stream_of(x2))
    _cuda.check(err, "ua2_fused_swiglu_tc")
    return out, h


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
    transformer's ``x + mlp(rmsnorm(x))``. One call is one launch of
    ``ua2_fused_swiglu`` (the two split-K passes) up to 16 rows and of
    ``ua2_fused_swiglu_tc`` (the two tile passes) above, as `swiglu_plan`
    says; ``.forms`` counts calls by "<gate/up>+<down>" form
    ("int4i+int4i", "int4g+int4cg", "int8+int8", ...). A call of the tile
    passes also counts pass 1 on `swiglu_tc` and pass 2 on `quant.gemv_tc`
    under W3's form."""
    lead = x.shape[:-1]
    n = w3.scale.shape[-1]
    if x.device.type == "cpu":
        return _twin(x, w1, w2, w3, norm_w, norm_eps, residual)
    x2, res2, m, k, i, n, g12, g3 = _operands("fused_swiglu", x, w1, w2, w3,
                                              norm_w, residual)
    dev = x2.device
    layout12, layout3 = LAYOUTS[type(w1)], LAYOUTS[type(w3)]
    plan = swiglu_plan(m, k, i, n, g12, layout12, g3, layout3,
                       quant._sm_count(dev))
    if plan.kind == "tile":
        out, _ = _tile_passes(x2, w1, w2, w3, norm_w, norm_eps, res2, plan)
        _cuda.count(swiglu_tc)
        _cuda.count(quant.gemv_tc, FORMS[type(w3)])
    else:
        out = _passes(x2, w1, w2, w3, norm_w, norm_eps, res2, plan)
    _cuda.count(fused_swiglu, f"{FORMS[type(w1)]}+{FORMS[type(w3)]}")
    return out.reshape(*lead, n)


def fused_swiglu_tiled(x, w1, w2, w3, *, norm_w=None, norm_eps=1e-5,
                       residual=None):
    """`fused_swiglu` through the first design's two tiled passes at any M
    (``ua2_fused_swiglu_tiled``), counted on its own by form: the yardstick
    the split-K and tile passes are timed against."""
    lead = x.shape[:-1]
    n = w3.scale.shape[-1]
    if x.device.type == "cpu":
        return _twin(x, w1, w2, w3, norm_w, norm_eps, residual)
    x2, res2, *_ = _operands("fused_swiglu_tiled", x, w1, w2, w3, norm_w,
                             residual)
    out = _tiled(x2, w1, w2, w3, norm_w, norm_eps, res2)
    _cuda.count(fused_swiglu_tiled, f"{FORMS[type(w1)]}+{FORMS[type(w3)]}")
    return out.reshape(*lead, n)


# the tile passes' pass-1 kernel (`swiglu_tc_kernel`), one a call above 16 rows
swiglu_tc = _cuda.Counter("swiglu_tc")
_cuda.reset_count(fused_swiglu)
_cuda.reset_count(fused_swiglu_tiled)
