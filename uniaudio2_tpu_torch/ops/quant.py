"""Weight-only quantization for the bandwidth-bound decode path (port of
`uniaudio2_tpu/ops/quant.py`).

Containers, quantizers and layouts are byte-identical to the JAX
package's: the same ``values`` (int8 storage, last axis zero-padded to a
multiple of 512, or 128 for small N) and the same f32 ``scale`` of TRUE
width, per output channel (``(N,)``) or per ``group`` input rows and
output channel (``(G, N)``, the ``*G`` containers). The port stores
serving weights row-major; chunk-major (``(C, K*, bc)``) is the TPU's
contiguous-DMA layout, kept here only for the bridge (`convert.from_jax`),
which un-chunks such leaves once at load time, and for the tests. The
GEMV wrappers raise on a chunk-major leaf.

Six kernels of the JAX package live here, as CUDA C++ for ``sm_90a``
(``csrc/gemv_*.cu`` over the shared ``csrc/gemv_common.cuh``):

* `int4i_matmul` replaces `_pallas_int4i_matmul` (row-interleaved int4,
  per-channel or grouped scales; at decode the split-K cluster kernel of
  ``csrc/gemv_int4_splitk.cuh``, planned by `gemv_plan`, above 16 rows the
  tensor-core tile kernel of ``csrc/gemv_int4_tc.cuh``, planned by
  `tc_plan`);
* `int8_matmul` replaces `_pallas_int8_matmul` (per-channel int8);
* `int4_matmul` replaces `_pallas_int4_matmul` (K-split int4; at decode
  the split-K cluster kernel, above 16 rows the tile kernel too);
* `int4g_matmul` replaces `_pallas_int4g_matmul` (K-split, grouped; at
  decode the split-K cluster kernel, above 16 rows the tile kernel too);
* `int4c_matmul` replaces `_pallas_int4c_matmul` (column-packed int4;
  above 16 rows the tensor-core tile kernel of ``csrc/gemv_int4_tc.cuh``,
  planned by `tc_plan`);
* `int4cg_matmul` replaces `_pallas_int4cg_matmul` (column-packed,
  grouped; above 16 rows the tile kernel too).

Each wrapper takes its plain twin (``*_plain``) only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. The twins follow
the JAX package's XLA fallback (`quant.matmul`): the scale is folded into
the weight, which is rounded to ``x.dtype`` before an f32-accumulated
product cast to ``x.dtype``. The kernels follow the Pallas kernels. With
per-channel scales the unscaled int weights are dotted in f32 and the
scale is applied to the f32 sum, then the residual, then one cast to the
output dtype. With grouped scales the f32 scale is multiplied into the
weight, the product rounded to ``x.dtype`` and then dotted in f32: the
twin's arithmetic up to the order of the sum. The column-packed kernels
fold neither the norm nor the residual (`matmul` applies both around
them, as the JAX package does). `gemv_tc` counts the tile kernel's
launches by form, beside the wrappers' own counts.
"""

from __future__ import annotations

import functools
import math
import re
from typing import NamedTuple, Optional, Tuple

import torch

from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.norms import rms_norm


class QuantizedLinear(NamedTuple):
    """Per-output-channel int8: values (..., K, N_padded), scale (..., N)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinear4(NamedTuple):
    """K-split packed int4: byte [k, n] holds row k in its low nibble and
    row k + K/2 in its high nibble. values (..., K/2, N_padded)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinear4G(NamedTuple):
    """`QuantizedLinear4` with one scale per ``group`` input rows per output
    channel: scale (..., G, N), G = K / group; group g covers rows
    [g*group, (g+1)*group). K/2 is divisible by ``group``, so each nibble
    half holds whole groups."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinearC4(NamedTuple):
    """Column-packed int4: byte [k, n] holds columns n (low nibble) and
    n + N/2 (high nibble). values (..., K, ceil(N/2) padded)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinearC4G(NamedTuple):
    """`QuantizedLinearC4` with group-wise scales: scale (..., G, N)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinearI4(NamedTuple):
    """Row-interleaved int4, the serving layout: byte [r, c] holds row 2r in
    its LOW nibble and row 2r+1 in its HIGH nibble. values (K/2, N_padded),
    scale (N,)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinearI4G(NamedTuple):
    """`QuantizedLinearI4` with group-wise scales: scale (G, N), K-axis
    groups of K/G rows exactly as `QuantizedLinear4G`."""

    values: torch.Tensor
    scale: torch.Tensor


GROUPED = (QuantizedLinear4G, QuantizedLinearC4G, QuantizedLinearI4G)
QUANTIZED = (QuantizedLinear, QuantizedLinear4, QuantizedLinearC4,
             QuantizedLinearI4) + GROUPED
INT4_GROUP = 128


def _align(n: int) -> int:
    return 512 if n >= 512 else 128


def _pad_last(q: torch.Tensor) -> torch.Tensor:
    n = q.shape[-1]
    a = _align(n)
    if n % a:
        q = torch.nn.functional.pad(q, (0, a - n % a))
    return q


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    """Low byte of an int32 tensor as int8 (two's-complement wrap, as
    ``astype(int8)`` in JAX)."""
    return (v & 0xFF).to(torch.uint8).view(torch.int8)


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int levels -> bytes with ``lo`` in the low and ``hi`` in the high
    nibble."""
    return _to_int8((hi.to(torch.int32) << 4) | (lo.to(torch.int32) & 0xF))


def _symmetric(w: torch.Tensor, levels: float):
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = amax / levels + 1e-12
    q = torch.clamp(torch.round(wf / scale), -levels, levels).to(torch.int32)
    return q, scale


def _symmetric_grouped(w: torch.Tensor, group: int):
    """int4 levels (..., K, N) and scales (..., G, N), one per ``group``
    rows and column."""
    wf = w.float()
    k, n = wf.shape[-2:]
    lead = wf.shape[:-2]
    wg = wf.reshape(*lead, k // group, group, n)
    amax = torch.amax(torch.abs(wg), dim=-2, keepdim=True)
    scale = amax / 7.0 + 1e-12
    q = torch.clamp(torch.round(wg / scale), -7.0, 7.0).to(torch.int32)
    return q.reshape(*lead, k, n), scale[..., 0, :]


def quantize(w: torch.Tensor) -> QuantizedLinear:
    """Per-output-channel symmetric int8 (last axis = output features)."""
    q, scale = _symmetric(w, 127.0)
    return QuantizedLinear(_pad_last(q.to(torch.int8)), scale[..., 0, :])


def quantize4(w: torch.Tensor) -> QuantizedLinear4:
    """Per-output-channel symmetric int4 (levels -7..7), K-split packing."""
    k = w.shape[-2]
    if k % 2:
        raise ValueError("int4 packing needs even K")
    q, scale = _symmetric(w, 7.0)
    packed = _pack_nibbles(q[..., : k // 2, :], q[..., k // 2:, :])
    return QuantizedLinear4(_pad_last(packed), scale[..., 0, :])


def quantize4_grouped(w: torch.Tensor,
                      group: int = INT4_GROUP) -> QuantizedLinear4G:
    """Symmetric int4 with per-(group, column) scales, K-split packing."""
    k = w.shape[-2]
    if k % (2 * group):
        raise ValueError("group must divide K/2")
    q, scale = _symmetric_grouped(w, group)
    packed = _pack_nibbles(q[..., : k // 2, :], q[..., k // 2:, :])
    return QuantizedLinear4G(_pad_last(packed), scale)


def quantize4_cols(w: torch.Tensor) -> QuantizedLinearC4:
    """Per-output-channel symmetric int4, packed along the output axis."""
    n = w.shape[-1]
    if n % 2:
        raise ValueError("column int4 packing needs even N")
    q, scale = _symmetric(w, 7.0)
    packed = _pack_nibbles(q[..., :, : n // 2], q[..., :, n // 2:])
    return QuantizedLinearC4(_pad_last(packed), scale[..., 0, :])


def quantize4_cols_grouped(w: torch.Tensor,
                           group: int = INT4_GROUP) -> QuantizedLinearC4G:
    """Symmetric int4, column-packed, per-(group, column) scales."""
    k, n = w.shape[-2:]
    if n % 2:
        raise ValueError("column int4 packing needs even N")
    if k % group:
        raise ValueError("group must divide K")
    q, scale = _symmetric_grouped(w, group)
    packed = _pack_nibbles(q[..., :, : n // 2], q[..., :, n // 2:])
    return QuantizedLinearC4G(_pad_last(packed), scale)


def _unpack4(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 bytes -> (low nibble, high nibble) as int32 in [-8, 7]."""
    v32 = v.to(torch.int32)
    return ((v32 & 0xF) ^ 8) - 8, v32 >> 4


def _unchunk_values(v: torch.Tensor) -> torch.Tensor:
    """(C, K*, bc) chunk-major -> (K*, C*bc) row-major."""
    if v.ndim == 2:
        return v
    c, k_, bc = v.shape
    return v.permute(1, 0, 2).reshape(k_, c * bc)


def is_chunk_major(w) -> bool:
    """Chunk-major values carry one more axis than row-major ones, on the
    values only (layer stacking adds one to values AND scale): two more
    than a per-channel scale, one more than a grouped (G, N) scale."""
    return w.values.ndim - w.scale.ndim == (1 if isinstance(w, GROUPED) else 2)


def chunk_major(w, bc: int):
    """(K*, N) -> (N/bc, K*, bc), zero-padding N up to a multiple of ``bc``
    (the TPU serving layout of `uniaudio2_tpu.ops.quant.chunk_major`; the
    port's kernels read row-major storage). No-op for other leaves, for
    column-packed, stacked or already chunked values and for N <= bc."""
    if not isinstance(w, QUANTIZED) or isinstance(
            w, (QuantizedLinearC4, QuantizedLinearC4G)):
        return w
    v = w.values
    if v.ndim != 2 or v.shape[-1] <= bc:
        return w
    if v.shape[-1] % bc:
        v = torch.nn.functional.pad(v, (0, bc - v.shape[-1] % bc))
    k_, n = v.shape
    return type(w)(v.reshape(k_, n // bc, bc).permute(1, 0, 2).contiguous(),
                   w.scale)


def _ksplit_levels(w) -> torch.Tensor:
    """K-split bytes -> (..., K, N) int32 levels in row order."""
    n = w.scale.shape[-1]
    return torch.cat(_unpack4(w.values[..., :n]), dim=-2)


def _cols_levels(w) -> torch.Tensor:
    """Column-packed bytes -> (..., K, N) int32 levels in column order."""
    n = w.scale.shape[-1]
    nh = n // 2
    lo, hi = _unpack4(w.values)
    return torch.cat([lo[..., :nh], hi[..., : n - nh]], dim=-1)


def _interleaved_levels(w) -> torch.Tensor:
    """Row-interleaved bytes -> (..., K, N) int32 levels in row order."""
    n = w.scale.shape[-1]
    lo, hi = _unpack4(w.values[..., :n])
    return torch.stack([lo, hi], dim=-2).reshape(
        *lo.shape[:-2], 2 * lo.shape[-2], n)


def _scaled(full: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Levels (..., K, N) times a per-channel (..., N) scale."""
    return (full.float() * scale[..., None, :]).to(dtype)


def _scaled_grouped(full: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Levels (..., K, N) times a grouped (..., G, N) scale."""
    k, n = full.shape[-2:]
    g = scale.shape[-2]
    lead = full.shape[:-2]
    out = full.float().reshape(*lead, g, k // g, n) * scale[..., :, None, :]
    return out.reshape(*lead, k, n).to(dtype)


_LEVELS = {
    QuantizedLinear: lambda w: w.values[..., : w.scale.shape[-1]],
    QuantizedLinear4: _ksplit_levels,
    QuantizedLinear4G: _ksplit_levels,
    QuantizedLinearC4: _cols_levels,
    QuantizedLinearC4G: _cols_levels,
    QuantizedLinearI4: _interleaved_levels,
    QuantizedLinearI4G: _interleaved_levels,
}


def levels(w) -> torch.Tensor:
    """The integer levels (..., K, N) of any quantized container, rows and
    columns in their true order, padding trimmed."""
    return _LEVELS[type(w)](w)


def dequantize_any(w, dtype=torch.bfloat16) -> torch.Tensor:
    """The (..., K, N) weight of any quantized container, in ``dtype``:
    levels times scale in f32, then one cast."""
    scaled = _scaled_grouped if isinstance(w, GROUPED) else _scaled
    return scaled(levels(w), w.scale, dtype)


def _dequantizer(cls):
    def dequantize_one(w, dtype=torch.bfloat16) -> torch.Tensor:
        if type(w) is not cls:
            raise TypeError(f"expected {cls.__name__}, got {type(w).__name__}")
        return dequantize_any(w, dtype)
    dequantize_one.__doc__ = f"`dequantize_any` of a {cls.__name__} only."
    return dequantize_one


# the JAX package's names, one per container
dequantize = _dequantizer(QuantizedLinear)
dequantize4 = _dequantizer(QuantizedLinear4)
dequantize4_grouped = _dequantizer(QuantizedLinear4G)
dequantize4_cols = _dequantizer(QuantizedLinearC4)
dequantize4_cols_grouped = _dequantizer(QuantizedLinearC4G)
dequantize4_interleaved = _dequantizer(QuantizedLinearI4)
dequantize4_interleaved_grouped = _dequantizer(QuantizedLinearI4G)


def _interleave_rows(full: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int nibble levels -> (..., K/2, N) bytes, even row in the
    low nibble, odd row in the high one."""
    return _pack_nibbles(full[..., 0::2, :], full[..., 1::2, :])


def to_interleaved(w):
    """Serving re-layout: K-split / column-packed int4 -> row-interleaved.
    Same quantized values and scales (per-channel or grouped); no-op for
    other leaves and for stacked values."""
    if isinstance(w, (QuantizedLinear4, QuantizedLinear4G)):
        if w.values.ndim != 2:
            return w
        cls = (QuantizedLinearI4G if isinstance(w, QuantizedLinear4G)
               else QuantizedLinearI4)
        return cls(_interleave_rows(torch.cat(_unpack4(w.values), dim=-2)),
                   w.scale)
    if isinstance(w, (QuantizedLinearC4, QuantizedLinearC4G)):
        if w.values.ndim != 2:
            return w
        n = w.scale.shape[-1]
        full = _cols_levels(w)
        if n % _align(n):
            full = torch.nn.functional.pad(full, (0, _align(n) - n % _align(n)))
        cls = (QuantizedLinearI4G if isinstance(w, QuantizedLinearC4G)
               else QuantizedLinearI4)
        return cls(_interleave_rows(full), w.scale)
    return w


# ---------------------------------------------------------------------------
# GEMV kernels and their plain twins
# ---------------------------------------------------------------------------


def _fallback(x, wd, out_dtype, pre_norm, residual):
    """The JAX package's XLA fallback: [rmsnorm(x)] @ wd in f32, cast to
    x.dtype, [+ residual in x.dtype], cast to ``out_dtype``."""
    xn = x if pre_norm is None else rms_norm(x, pre_norm[0], pre_norm[1])
    out = torch.matmul(xn.float(), wd.float()).to(x.dtype)
    if residual is not None:
        out = out + residual.to(out.dtype)
    return out.to(out_dtype) if out_dtype is not None else out


def matmul_plain(x, w, *, out_dtype=None, pre_norm=None, residual=None):
    """x (M, K) @ the dequantized container ``w`` -> (M, N): the plain twin
    of every GEMV kernel, by container type."""
    return _fallback(x, dequantize_any(w, x.dtype), out_dtype, pre_norm,
                     residual)


def int4i_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """Plain twin of `int4i_matmul` (per-channel or grouped scale)."""
    cls = QuantizedLinearI4G if scale.ndim == 2 else QuantizedLinearI4
    return matmul_plain(x, cls(values, scale), out_dtype=out_dtype,
                        pre_norm=pre_norm, residual=residual)


def int8_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                      residual=None):
    """Plain twin of `int8_matmul`: x (M, K) @ dequantized int8 -> (M, N)."""
    return matmul_plain(x, QuantizedLinear(values, scale), out_dtype=out_dtype,
                        pre_norm=pre_norm, residual=residual)


def int4_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                      residual=None):
    """Plain twin of `int4_matmul`: x (M, K) @ dequantized K-split int4."""
    return matmul_plain(x, QuantizedLinear4(values, scale), out_dtype=out_dtype,
                        pre_norm=pre_norm, residual=residual)


def int4g_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """Plain twin of `int4g_matmul`: K-split int4, grouped scale (G, N)."""
    return matmul_plain(x, QuantizedLinear4G(values, scale),
                        out_dtype=out_dtype, pre_norm=pre_norm,
                        residual=residual)


def int4c_matmul_plain(x, values, scale, *, out_dtype=None):
    """Plain twin of `int4c_matmul`: x (M, K) @ dequantized column-packed
    int4 (no norm, no residual)."""
    return matmul_plain(x, QuantizedLinearC4(values, scale), out_dtype=out_dtype)


def int4cg_matmul_plain(x, values, scale, *, out_dtype=None):
    """Plain twin of `int4cg_matmul`: column-packed int4, grouped scale."""
    return matmul_plain(x, QuantizedLinearC4G(values, scale),
                        out_dtype=out_dtype)


GEMV_TILE_N = 64     # output columns per block of the GEMV kernels
# weight layouts, as csrc/gemv_common.cuh numbers them
LAYOUT_INT8, LAYOUT_I4, LAYOUT_K4, LAYOUT_C4 = 0, 1, 2, 3
LAYOUTS = {QuantizedLinear: LAYOUT_INT8, QuantizedLinearI4: LAYOUT_I4,
           QuantizedLinearI4G: LAYOUT_I4, QuantizedLinear4: LAYOUT_K4,
           QuantizedLinear4G: LAYOUT_K4, QuantizedLinearC4: LAYOUT_C4,
           QuantizedLinearC4G: LAYOUT_C4}


def check_operand(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_weight(name, layout, values, scale, k, device) -> Tuple[int, int]:
    """Validate one row-major quantized weight of contraction width ``k``
    against the kernels' layout rules, on any device. Returns (N, G): the
    true output width and the number of scale groups (0 = per-channel)."""
    if values.ndim != 2:
        raise ValueError(f"{name}: values must be row-major 2-D, got "
                         f"{tuple(values.shape)} (chunk-major leaves are "
                         f"un-chunked by convert.from_jax at load time)")
    if scale.ndim not in (1, 2) or (scale.ndim == 2 and layout == LAYOUT_INT8):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} does not fit "
                         f"the layout")
    n = scale.shape[-1]
    g = scale.shape[0] if scale.ndim == 2 else 0
    kb, ldw = values.shape
    packed_rows = layout in (LAYOUT_I4, LAYOUT_K4)
    width = n - n // 2 if layout == LAYOUT_C4 else n
    if kb * (2 if packed_rows else 1) != k or ldw < width \
            or ldw % GEMV_TILE_N:
        raise ValueError(f"{name}: values {tuple(values.shape)} do not fit "
                         f"K = {k} / scale {tuple(scale.shape)}")
    if g:
        # a byte's two rows lie in one group (interleaved: an even group
        # size) or each nibble half holds whole groups (K-split: even G)
        ok = k % g == 0 and {LAYOUT_I4: (k // g) % 2 == 0,
                             LAYOUT_K4: g % 2 == 0,
                             LAYOUT_C4: True}[layout]
        if not ok:
            raise ValueError(f"{name}: {g} scale groups do not divide "
                             f"K = {k} in this layout")
    check_operand(values, f"{name}.values", torch.int8, (kb, ldw), device)
    check_operand(scale, f"{name}.scale", torch.float32, tuple(scale.shape),
                  device)
    return n, g


# The split-K GEMV (csrc/gemv_int4_splitk.cuh) of rows 1, 5 and 6 and of the
# fused SwiGLU's two passes at decode: up to SPLITK_MAX_M activation rows
# (one tile of the tensor cores' 16 rows), at most SPLITK_MAX_SPLITS
# K-slices a cluster, GEMV_TILE_N byte columns a block; SPLITK_BLOCKS_PER_SM
# blocks an SM is the grid it aims at (`gemv_plan`).
SPLITK_MAX_M = 16
SPLITK_MAX_SPLITS = 8
SPLITK_BLOCKS_PER_SM = 2.25
SPLITK_STEP = 8      # pairs of rows a warp step of the int8 / C4 layouts


class GemvPlan(NamedTuple):
    """How one int4 GEMV call is launched. ``splits`` K-slices (0: the tiled
    kernel of every row tile over all of K), ``mt`` activation rows a block,
    ``tile`` output columns a block and ``span`` byte rows a slice."""

    splits: int
    mt: int
    tile: int
    span: int

    def blocks(self, m: int, n: int) -> int:
        """The grid's blocks for an (m, n) output."""
        return (-(-n // self.tile) * -(-m // self.mt)
                * max(self.splits, 1))


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, k: int, n: int, g: int, layout: int,
              sms: int, max_splits: int = SPLITK_MAX_SPLITS) -> GemvPlan:
    """The launch of a split-K GEMV of layout ``layout`` with ``g`` scale
    groups (0: per channel) on a card of ``sms`` SMs: a function of the
    shape and the SM count only. The row-packed int4 layouts
    (`LAYOUT_I4`, `LAYOUT_K4`: rows 1, 5 and 6, the fused SwiGLU's gate /
    up and interleaved down-projection) and the fused SwiGLU's int8
    (`LAYOUT_INT8`) and column-packed (`LAYOUT_C4`, byte column c holds
    output columns c and N/2 + c) ones; the fused SwiGLU's pass 1 asks
    with ``n`` = 2 I, its two weights' column tiles. Up to `SPLITK_MAX_M`
    rows: the split-K kernel, all rows in one block (the MMA's 16), and
    the number of K-slices, up to ``max_splits`` (`SPLITK_MAX_SPLITS`; the
    QKV step caps it lower, `qkv_step.QKV_MAX_SPLITS`), whose grid comes
    nearest (in ratio) `SPLITK_BLOCKS_PER_SM` blocks an SM, the fewer
    slices on a tie. The kernel's rows are K/2 byte rows (row-packed) or
    K/2 pairs of rows (int8, column-packed: row 16 s + j with 16 s + j + 8,
    a step of 16 rows). Every slice but the last holds the same whole
    number of units and none is empty; a unit is a byte row, or a scale
    group when grouped: K/G / 2 byte rows in the interleaved layout (both
    nibbles of a byte share a group), K/G in the K-split one (the low and
    high halves each hold G/2 groups); for int8 and column-packed a step of
    8 pairs, or grouped the lcm of a step and K/G / 2 pairs. Above
    `SPLITK_MAX_M` rows: the tiled kernel."""
    if m > SPLITK_MAX_M:
        return GemvPlan(0, 4, GEMV_TILE_N, k // 2)
    mt = SPLITK_MAX_M
    width = n - n // 2 if layout == LAYOUT_C4 else n
    tiles = -(-width // GEMV_TILE_N) * -(-m // mt)
    want = SPLITK_BLOCKS_PER_SM * sms
    s, span = min(splitk_slices(k, g, layout, max_splits),
                  key=lambda c: (abs(math.log(tiles * c[0] / want)), c[0]))
    return GemvPlan(s, mt, GEMV_TILE_N, span)


def splitk_slices(k: int, g: int, layout: int,
                  max_splits: int = SPLITK_MAX_SPLITS):
    """Every legal (K-slices, rows a slice) of the split-K kernel for
    contraction width ``k`` with ``g`` scale groups (`gemv_plan`'s units):
    up to ``max_splits`` slices, none empty."""
    rows = k // 2
    if layout in (LAYOUT_INT8, LAYOUT_C4):
        unit = math.lcm(SPLITK_STEP, max((k // g) // 2, 1)) if g else SPLITK_STEP
    else:
        unit = 1 if not g else (k // g) // 2 if layout == LAYOUT_I4 else k // g
    units = rows // unit
    out = []
    for s in range(1, min(max_splits, units) + 1):
        per = -(-units // s)                      # units a slice
        if (s - 1) * per < units:                 # no slice empty
            out.append((s, per * unit))
    return out


# The blocks a wave of the tile kernel's clusters can hold, an SM: clusters
# are placed whole inside a GPC, so clusters of three or more slices fill
# fewer than one block an SM (`TC_BLOCKS_PER_SM`), clusters of one or two
# every SM (`TC_PAIR_BLOCKS_PER_SM`). Chosen by `probes/tc_splits_sweep.py`
# on the H100 (132 SMs): at each of its 41 cases the fastest slice count
# with its clusters in one wave is the most with <= 96 blocks, or, in
# clusters of two, <= 132 (64 column tiles x 2 read 1.6-1.7x faster than
# 64 x 1, where 24 x 5 = 120 blocks read 1.6x slower than 24 x 4). The
# card's own count, cudaOccupancyMaxActiveClusters, is 132, 66, 39, 30, 22,
# 17, 15 and 15 clusters of 1-8 blocks there: at every S at least what
# this rule allows, so a plan never spills into a second wave.
TC_BLOCKS_PER_SM = 0.75
TC_PAIR_BLOCKS_PER_SM = 1.0


def tc_wave(splits: int, sms: int) -> int:
    """The blocks one wave of the tile kernel's clusters of ``splits``
    blocks holds on a card of ``sms`` SMs (`TC_BLOCKS_PER_SM`,
    `TC_PAIR_BLOCKS_PER_SM`)."""
    rate = TC_PAIR_BLOCKS_PER_SM if splits <= 2 else TC_BLOCKS_PER_SM
    return int(rate * sms)


class TcLayout(NamedTuple):
    """The tensor-core tile kernel's constants (csrc/gemv_int4_tc.cuh):
    ``bk`` input rows a stage of its ring, ``bn`` activation rows a block
    (wgmma's N), ``bc`` byte columns a block of the column-packed layout
    (twice as many output columns, the block's width in every layout), at
    most ``max_splits`` K-slices a cluster."""

    bk: int
    bn: int
    bc: int
    max_splits: int

    def col_tiles(self, n: int, layout: int = LAYOUT_C4) -> int:
        """Column tiles of an ``n``-wide output: the column-packed layout
        covers columns c and N/2 + c with byte column c (``bc`` byte
        columns a block), the row-packed ones (`LAYOUT_I4`, `LAYOUT_K4`)
        one output column a byte column (2 ``bc`` a block)."""
        if layout == LAYOUT_C4:
            return -(-(n - n // 2) // self.bc)
        return -(-n // (2 * self.bc))


@functools.lru_cache(maxsize=None)
def tc_layout() -> TcLayout:
    """`TcLayout`, read from the kernel's source, the only copy."""
    text = (_cuda.CSRC / "gemv_int4_tc.cuh").read_text()
    return TcLayout(*(int(re.search(rf"constexpr int {name} = (\d+);",
                                    text).group(1))
                      for name in ("BK", "BN", "BC", "MAX_SPLITS")))


class TcPlan(NamedTuple):
    """How one int4 GEMV above `SPLITK_MAX_M` rows is launched: ``splits``
    K-slices of ``span`` input rows, one cluster a (column, row) tile of
    the tile kernel; ``splits`` = 0: the tiled kernel of
    `gemv_common.cuh`."""

    splits: int
    span: int

    def grid(self, m: int, n: int,
             layout: int = LAYOUT_C4) -> Tuple[int, int, int]:
        """(column tiles, K-slices, row tiles) of an (m, n) output in
        ``layout``, for a plan of the tile kernel (``splits`` > 0)."""
        lay = tc_layout()
        return (lay.col_tiles(n, layout), self.splits, -(-m // lay.bn))

    def blocks(self, m: int, n: int, layout: int = LAYOUT_C4) -> int:
        return math.prod(self.grid(m, n, layout))


@functools.lru_cache(maxsize=None)
def tc_plan(m: int, k: int, n: int, g: int, sms: int,
            layout: int = LAYOUT_C4) -> TcPlan:
    """The launch of an int4 GEMV above the decode rows (`int4c_matmul`,
    `int4cg_matmul`; `int4i_matmul` and `int4g_matmul` above
    `SPLITK_MAX_M` rows) of ``m`` rows, contraction width ``k``, ``n``
    output columns, ``g`` scale groups (0: per channel) and weight layout
    ``layout`` (`LAYOUT_C4`, `LAYOUT_I4` or `LAYOUT_K4`) on a card of
    ``sms`` SMs: a function of the shape and the SM count only.

    The tiled kernel (``splits`` = 0) takes up to `SPLITK_MAX_M` rows, and
    the shapes the tile kernel does not: K not a multiple of 8 (its TMA
    boxes need 16-byte rows) or, grouped, a group of K/G rows that is not a
    whole number of k-steps of 16. (The column-packed C entry points also
    send a call with a norm or a residual to it; their wrappers pass
    neither.) Above that the tile kernel, which masks the ragged edges
    itself (rows past M and K read as zeros, columns past N are not
    written), over S K-slices: the most that keep its clusters in one wave
    on the card (column tiles x row tiles x S <= `tc_wave` (S, ``sms``)),
    at least 1 and at most ``max_splits``. Every slice but the
    last is a whole number of units (`bk` rows; grouped, the least common
    multiple of `bk` and K/G, so that scale groups stay whole, and for the
    K-split layout of `bk` and 2 K/G: its slice of the reordered x covers
    span / 2 rows of each K half, whole groups of both), and none is
    empty. The S partial tiles of a tile are added in rank order, so the
    sum's order is fixed by the plan.

    On 132 SMs, per channel and grouped at K/G = 128: column-packed (255,
    8192 -> 3072) 24 tiles x 4 slices of 2048 rows = 96 blocks; (510, 8192
    -> 3072) 48 x 2 slices of 4096 = 96; (255, 8192 -> 2048) 16 x 6 slices
    of 1408 = 96; (510, 8192 -> 2048) 32 x 3 of 2752 (grouped 2816) = 96.
    Row-packed (128 output columns a tile): (255, 3072 -> 5120) 40 x 2
    slices of 1536 = 80; (255, 3072 -> 3072) 24 x 4 of 768 = 96; (255,
    3072 -> 8192) 64 x 2 of 1536 = 128; (255, 8192 -> 3072) 24 x 4 of 2048
    = 96; (510, 3072 -> 8192) 128 x 1 = 128.
    The rule against every S from 1 to 8 at those shapes:
    `probes/tc_splits_sweep.py`."""
    if m <= SPLITK_MAX_M or k % 8 or (g and (k // g) % 16):
        return TcPlan(0, k)
    lay = tc_layout()
    tiles = lay.col_tiles(n, layout) * -(-m // lay.bn)
    group = (2 * k // g if layout == LAYOUT_K4 else k // g) if g else 0
    unit = math.lcm(lay.bk, group) if g else lay.bk
    units = -(-k // unit)
    s = max([c for c in range(1, min(lay.max_splits, units) + 1)
             if tiles * c <= tc_wave(c, sms)], default=1)
    span = -(-units // s) * unit
    return TcPlan(-(-k // span), span)


gemv_tc = _cuda.Counter("gemv_tc")     # the tile kernel's launches by form


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_gemv(fn_name, layout, x, values, scale, out_dtype, pre_norm,
                 residual, planner=None):
    """One launch of the C entry point ``fn_name``; returns the output and
    whether the plan named the tile kernel."""
    dev = x.device
    if x.ndim != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"{fn_name}: x must be 2-D bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    n, g = check_weight(fn_name, layout, values, scale, k, dev)
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    norm_w, eps = (None, 1e-5) if pre_norm is None else pre_norm
    if norm_w is not None:
        check_operand(norm_w, "norm_w", torch.bfloat16, (k,), dev)
    if residual is not None:
        check_operand(residual, "residual", torch.bfloat16, (m, n), dev)
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"{fn_name}: out_dtype {out_dtype} not supported")
    out = torch.empty((m, n), dtype=out_dtype or torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return out, False
    plan, tile = (), False
    if planner == "tc" or (planner == "rows" and m > SPLITK_MAX_M):
        p = tc_plan(m, k, n, g, _sm_count(dev), layout)
        tile = p.splits > 0
        if tile and (values.data_ptr() % 16 or x.data_ptr() % 16):
            raise ValueError(f"{fn_name}: x and values must be 16-byte "
                             f"aligned")
        plan = (p.splits, p.span) if planner == "tc" else (
            p.splits, tc_layout().bn, p.span)
    elif planner == "rows":
        if values.data_ptr() % 16:
            raise ValueError(f"{fn_name}: values must be 16-byte aligned")
        p = gemv_plan(m, k, n, g, layout, _sm_count(dev))
        plan = (p.splits, p.mt, p.span)
    if planner == "rows":
        # the tile kernel reads x through this scratch copy (normalised,
        # and for the K-split layout reordered) when it folds a norm or
        # runs the K-split layout
        staged = tile and (norm_w is not None or layout == LAYOUT_K4)
        xn = torch.empty((m, k), dtype=torch.bfloat16, device=dev) \
            if staged else None
        plan += (_cuda.ptr(xn),)
    lib = _cuda.lib()
    err = getattr(lib, fn_name)(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(norm_w),
        _cuda.ptr(residual), _cuda.ptr(out), m, k, n, values.shape[1], g,
        float(eps), int(out.dtype == torch.float32), *plan,
        _cuda.stream_of(x))
    _cuda.check(err, fn_name)
    return out, tile


def _gemv(wrapper, c_name, cls, x, values, scale, out_dtype, pre_norm=None,
          residual=None, form=None, planner=None):
    """The body of every GEMV wrapper: validate ``values`` / ``scale`` as a
    container of type ``cls``, then the plain twin for a CPU tensor, else
    one launch of the C entry point ``c_name`` (given `tc_plan`'s plan
    when ``planner`` is "tc", `gemv_plan`'s up to `SPLITK_MAX_M` rows and
    `tc_plan`'s above when it is "rows"),
    counted on ``wrapper`` and, when the plan named the tile kernel, on
    `gemv_tc` under the wrapper's form."""
    name = wrapper.__name__
    if (scale.ndim == 2) != (cls in GROUPED):
        raise ValueError(
            f"{name}: expected a "
            f"{'grouped (G, N)' if cls in GROUPED else 'per-channel (N,)'} "
            f"scale, got {tuple(scale.shape)}")
    if x.device.type == "cpu":
        check_weight(name, LAYOUTS[cls], values, scale, x.shape[-1], x.device)
        return matmul_plain(x, cls(values, scale), out_dtype=out_dtype,
                            pre_norm=pre_norm, residual=residual)
    out, tile = _launch_gemv(c_name, LAYOUTS[cls], x, values, scale,
                             out_dtype, pre_norm, residual, planner)
    _cuda.count(wrapper, form)
    if tile:
        _cuda.count(gemv_tc, form or name.removesuffix("_matmul"))
    return out


def int4i_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                 residual=None):
    """x (M, K) bf16 @ row-interleaved int4 (K/2, N_pad) * scale ((N,), or
    grouped (G, N)) [+ residual (M, N)] -> (M, N), with an optional RMSNorm
    prologue ``pre_norm=(weight, eps)``. CUDA kernel ``ua2_gemv_int4i``
    (replaces `_pallas_int4i_matmul`, uniaudio2_tpu/ops/quant.py:948): up
    to `SPLITK_MAX_M` rows the split-K kernel as `gemv_plan` says, above
    them the tensor-core tile kernel (a norm: its row kernel first) or, at
    shapes it does not take, the tiled kernel, as `tc_plan` says; the
    plain twin for CPU tensors. ``.forms`` counts the launches of the
    "int4i" (per-channel) and "int4ig" (grouped) forms."""
    grouped = scale.ndim == 2
    return _gemv(int4i_matmul, "ua2_gemv_int4i",
                 QuantizedLinearI4G if grouped else QuantizedLinearI4, x,
                 values, scale, out_dtype, pre_norm, residual,
                 form="int4ig" if grouped else "int4i", planner="rows")


def int4i_matmul_tiled(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """`int4i_matmul` through the tiled kernel at any M
    (``ua2_gemv_int4i_tiled``), counted on its own. No serving path calls
    it: it is the yardstick the split-K and tile kernels are timed against
    and the kernel row 11 is bit-checked against."""
    grouped = scale.ndim == 2
    return _gemv(int4i_matmul_tiled, "ua2_gemv_int4i_tiled",
                 QuantizedLinearI4G if grouped else QuantizedLinearI4, x,
                 values, scale, out_dtype, pre_norm, residual)


def int8_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                residual=None):
    """x (M, K) bf16 @ int8 (K, N_pad) * scale (N,) [+ residual] -> (M, N),
    optional RMSNorm prologue. CUDA kernel ``ua2_gemv_int8`` (replaces
    `_pallas_int8_matmul`, uniaudio2_tpu/ops/quant.py:483); the plain twin
    for CPU tensors."""
    return _gemv(int8_matmul, "ua2_gemv_int8", QuantizedLinear, x, values,
                 scale, out_dtype, pre_norm, residual)


def int4_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                residual=None):
    """x (M, K) bf16 @ K-split int4 (K/2, N_pad) * scale (N,) [+ residual]
    -> (M, N), optional RMSNorm prologue: byte [r, n] holds row r (low
    nibble) and row r + K/2 (high). CUDA kernel ``ua2_gemv_int4`` (replaces
    `_pallas_int4_matmul`, uniaudio2_tpu/ops/quant.py:597): the split-K
    kernel up to `SPLITK_MAX_M` rows, the tensor-core tile kernel above
    them (after its row kernel, which reorders x and folds the norm; the
    scale and the residual in its epilogue), or the tiled kernel where
    `tc_plan` says; the plain twin for CPU tensors."""
    return _gemv(int4_matmul, "ua2_gemv_int4", QuantizedLinear4, x, values,
                 scale, out_dtype, pre_norm, residual, planner="rows")


def int4_matmul_tiled(x, values, scale, *, out_dtype=None, pre_norm=None,
                      residual=None):
    """`int4_matmul` through the tiled kernel at any M
    (``ua2_gemv_int4_tiled``), counted on its own; the yardstick, as
    `int4i_matmul_tiled`, and the kernel whose bits rows 13 (form 0) and
    14 give."""
    return _gemv(int4_matmul_tiled, "ua2_gemv_int4_tiled", QuantizedLinear4,
                 x, values, scale, out_dtype, pre_norm, residual)


def int4g_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                 residual=None):
    """`int4_matmul` with a grouped scale (G, N): rows of the low nibbles
    take groups [0, G/2), rows of the high nibbles [G/2, G). CUDA kernel
    ``ua2_gemv_int4g`` (replaces `_pallas_int4g_matmul`,
    uniaudio2_tpu/ops/quant.py:712): the split-K kernel up to
    `SPLITK_MAX_M` rows, the tensor-core tile kernel above them (after its
    row kernel, which reorders x and folds the norm), or the tiled kernel
    where `tc_plan` says; the plain twin for CPU tensors."""
    return _gemv(int4g_matmul, "ua2_gemv_int4g", QuantizedLinear4G, x, values,
                 scale, out_dtype, pre_norm, residual, planner="rows")


def int4g_matmul_tiled(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """`int4g_matmul` through the tiled kernel at any M
    (``ua2_gemv_int4g_tiled``), counted on its own; the yardstick, as
    `int4i_matmul_tiled`."""
    return _gemv(int4g_matmul_tiled, "ua2_gemv_int4g_tiled",
                 QuantizedLinear4G, x, values, scale, out_dtype, pre_norm,
                 residual)


def int4c_matmul(x, values, scale, *, out_dtype=None):
    """x (M, K) bf16 @ column-packed int4 (K, halfpad) * scale (N,) ->
    (M, N): byte [k, n] holds column n (low nibble) and column n + N/2
    (high). No norm and no residual, as the Pallas kernel (`matmul`
    applies both around the product, as the JAX package does). CUDA kernel
    ``ua2_gemv_int4c`` (replaces `_pallas_int4c_matmul`,
    uniaudio2_tpu/ops/quant.py:799), one launch: above `SPLITK_MAX_M` rows
    the tensor-core tile kernel of ``csrc/gemv_int4_tc.cuh`` with
    `tc_plan`'s launch, else the tiled kernel; the plain twin for CPU
    tensors."""
    return _gemv(int4c_matmul, "ua2_gemv_int4c", QuantizedLinearC4, x, values,
                 scale, out_dtype, planner="tc")


def int4c_matmul_tiled(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """`int4c_matmul` through the tiled kernel at any M
    (``ua2_gemv_int4c_tiled``), counted on its own: the yardstick the tile
    kernel is timed against, with the norm prologue and the residual the
    tiled kernel folds. No serving path calls it."""
    return _gemv(int4c_matmul_tiled, "ua2_gemv_int4c_tiled",
                 QuantizedLinearC4, x, values, scale, out_dtype, pre_norm,
                 residual)


def int4cg_matmul(x, values, scale, *, out_dtype=None):
    """`int4c_matmul` with a grouped scale (G, N). CUDA kernel
    ``ua2_gemv_int4cg`` (replaces `_pallas_int4cg_matmul`,
    uniaudio2_tpu/ops/quant.py:864), the tile kernel or the tiled one as
    `tc_plan` says; the plain twin for CPU tensors."""
    return _gemv(int4cg_matmul, "ua2_gemv_int4cg", QuantizedLinearC4G, x,
                 values, scale, out_dtype, planner="tc")


def int4cg_matmul_tiled(x, values, scale, *, out_dtype=None, pre_norm=None,
                        residual=None):
    """`int4cg_matmul` through the tiled kernel at any M
    (``ua2_gemv_int4cg_tiled``), counted on its own; the yardstick, as
    `int4c_matmul_tiled`."""
    return _gemv(int4cg_matmul_tiled, "ua2_gemv_int4cg_tiled",
                 QuantizedLinearC4G, x, values, scale, out_dtype, pre_norm,
                 residual)


for _fn in (int4i_matmul, int8_matmul, int4_matmul, int4g_matmul,
            int4c_matmul, int4cg_matmul, int4i_matmul_tiled,
            int4g_matmul_tiled, int4_matmul_tiled, int4c_matmul_tiled,
            int4cg_matmul_tiled):
    _cuda.reset_count(_fn)

_GEMV = {QuantizedLinear: int8_matmul, QuantizedLinearI4: int4i_matmul,
         QuantizedLinearI4G: int4i_matmul, QuantizedLinear4: int4_matmul,
         QuantizedLinear4G: int4g_matmul, QuantizedLinearC4: int4c_matmul,
         QuantizedLinearC4G: int4cg_matmul}


def kernel_eligible(w, k: int) -> bool:
    """The JAX package's predicate (`quant.matmul`) for sending a product
    of contraction width ``k`` to the container's Pallas kernel; the others
    dequantize and multiply there. The CUDA kernels have no such tiling
    rule, so on the card `matmul` does not ask: here the predicate only
    picks which of the two rounding orders the CPU twin follows."""
    if isinstance(w, QuantizedLinear):
        return k % 128 == 0
    if isinstance(w, (QuantizedLinearC4, QuantizedLinearC4G)):
        return k % 128 == 0 and (not isinstance(w, QuantizedLinearC4G)
                                 or k % w.scale.shape[-2] == 0)
    if k % 256:
        return False
    if isinstance(w, QuantizedLinearI4G):
        return k % w.scale.shape[-2] == 0
    if isinstance(w, QuantizedLinear4G):
        g = w.scale.shape[-2]
        return k % g == 0 and (k // 2) % (k // g) == 0
    return True


def matmul(x: torch.Tensor, w, out_dtype=None, pre_norm=None,
           residual=None) -> torch.Tensor:
    """``x @ w`` over the last axis; ``w`` may be a plain (K, N) tensor or a
    quantized container. ``out_dtype`` forces the output dtype,
    ``pre_norm=(weight, eps)`` folds a leading RMSNorm of ``x``,
    ``residual`` (the output's shape) folds a residual add — the
    `uniaudio2_tpu.ops.quant.matmul` contract. On the card a quantized
    product always launches its container's kernel (or raises where
    `check_weight` refuses the leaf); on the CPU it follows the rounding
    order of the branch the JAX dispatcher takes (`kernel_eligible`)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if isinstance(w, QUANTIZED):
        if w.values.ndim != 2:
            raise ValueError(
                f"matmul: {type(w).__name__} values must be row-major 2-D, "
                f"got {tuple(w.values.shape)} (chunk-major leaves are "
                f"un-chunked by convert.from_jax at load time)")
        n = w.scale.shape[-1]
        x2 = x.reshape(-1, k)
        res2 = None if residual is None else residual.reshape(-1, n)
        if x.device.type == "cpu" and not kernel_eligible(w, k):
            out = _fallback(x2, dequantize_any(w, x.dtype), out_dtype,
                            pre_norm, res2)
        elif isinstance(w, (QuantizedLinearC4, QuantizedLinearC4G)):
            # the column-packed kernels fold nothing: norm before, residual
            # after the output was rounded
            if pre_norm is not None:
                x2 = rms_norm(x2, pre_norm[0], pre_norm[1])
            out = _GEMV[type(w)](x2.contiguous(), w.values, w.scale,
                                 out_dtype=out_dtype)
            if res2 is not None:
                out = out + res2.to(out.dtype)
        else:
            out = _GEMV[type(w)](
                x2.contiguous(), w.values, w.scale, out_dtype=out_dtype,
                pre_norm=pre_norm,
                residual=None if res2 is None else res2.contiguous())
        return out.reshape(*lead, -1)
    if pre_norm is not None:
        x = rms_norm(x, pre_norm[0], pre_norm[1])
    if (x.is_cuda and x.dtype == w.dtype == torch.bfloat16
            and out_dtype in (None, torch.bfloat16) and residual is None):
        # the training forward's products, on the tensor cores: bf16
        # operands, float32 accumulation, one rounding to bf16. With
        # torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        # off (train.main turns it off) cuBLAS also sums split-K partials
        # in float32, so this agrees with the float32 form below up to the
        # order of the sums; with it on, partials may be rounded to bf16
        return torch.matmul(x, w)
    out = torch.matmul(x.float(), w.float()).to(out_dtype or torch.float32)
    if residual is not None:
        out = out + residual.to(out.dtype)
    return out if out_dtype is not None else out.to(x.dtype)


# ---------------------------------------------------------------------------
# Param-tree quantization
# ---------------------------------------------------------------------------

_GPT_QUANT_LEAVES = (
    "qkv_w", "attn_proj_w", "fc1_w", "fc2_w", "mlp_proj_w", "lm_head_w",
)


def _q(w: torch.Tensor, bits=8, cols: bool = False):
    """Quantize one leaf. ``bits`` is 8, 4 (per-channel scales) or "4g"
    (group-wise scales of `INT4_GROUP` rows); a leaf whose K the groups do
    not divide falls back to per-channel int4, as in the JAX package."""
    if bits == "4g":
        k = w.shape[-2]
        if cols and k % INT4_GROUP == 0:
            return quantize4_cols_grouped(w)
        if not cols and k % (2 * INT4_GROUP) == 0:
            return quantize4_grouped(w)
        bits = 4
    if bits == 4 and cols:
        return quantize4_cols(w)
    if bits == 4:
        return quantize4(w)
    return quantize(w)


def quantize_gpt_params(params, *, bits=8, lm_head_bits: Optional[int] = None):
    """Quantize a GPT tree's matmul weights (layer-stacked leaves get
    per-layer scales); embeddings and norms stay as they are. ``bits`` is
    8, 4 or "4g". The lm_head stays int8 even under int4; under int4 the
    MLP down-projection is column-packed. MoE expert stacks are not
    quantized (as in JAX)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _GPT_QUANT_LEAVES:
        if name in layers and layers[name].ndim == 3:
            layers[name] = _q(layers[name], bits,
                              cols=bits in (4, "4g") and name == "mlp_proj_w")
    out["layers"] = layers
    if "lm_head_w" in out:
        out["lm_head_w"] = _q(out["lm_head_w"], lm_head_bits or 8)
    return out


def quantize_unified_params(params, *, int4_modules: Tuple[str, ...] = (),
                            grouped: bool = False):
    """Quantize the unified model's weight matrices for serving: int4 for
    the submodules named in ``int4_modules`` ("backbone", "decoder",
    "understanding_expert", "generation_expert", "projection_w",
    "audio_head"), int8 elsewhere; with ``grouped`` the int4 modules take
    group-wise scales (`quantize4_grouped`)."""
    four = "4g" if grouped else 4
    out = dict(params)
    for sub in ("backbone", "decoder", "understanding_expert",
                "generation_expert"):
        out[sub] = quantize_gpt_params(
            params[sub], bits=four if sub in int4_modules else 8)
    out["projection_w"] = _q(params["projection_w"],
                             four if "projection_w" in int4_modules else 8)
    out["audio_head"] = _q(params["audio_head"],
                           four if "audio_head" in int4_modules else 8)
    return out
