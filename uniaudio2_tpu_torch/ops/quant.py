"""Weight-only quantization for the bandwidth-bound decode path (port of
`uniaudio2_tpu/ops/quant.py`).

Containers, quantizers and layouts are byte-identical to the JAX
package's: the same ``values`` (int8 storage, last axis zero-padded to a
multiple of 512, or 128 for small N) and the same f32 ``scale`` of TRUE
width. The port stores serving weights row-major; chunk-major
(``(C, K*, bc)``) is the TPU's contiguous-DMA layout, kept here only for
the bridge (`convert.from_jax`), which un-chunks such leaves once at load
time, and for the tests. The GEMV wrappers raise on a chunk-major leaf.

Two kernels of the JAX package live here, as CUDA C++ for ``sm_90a``
(``csrc/gemv_int4i.cu`` and ``csrc/gemv_int8.cu``):

* `int4i_matmul` replaces `_pallas_int4i_matmul` (row-interleaved int4);
* `int8_matmul` replaces `_pallas_int8_matmul` (per-channel int8).

Each wrapper takes its plain twin (`int4i_matmul_plain`,
`int8_matmul_plain`) only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. The twins follow the JAX package's XLA
fallback (`quant.matmul`): the scale is folded into the weight, which is
rounded to ``x.dtype`` before an f32-accumulated product cast to
``x.dtype``. The kernels follow the Pallas kernels: the unscaled int
weights are dotted in f32 and the scale is applied to the f32 sum, then the
residual, then one cast to the output dtype.

Grouped-scale formats (`QuantizedLinear4G`/`C4G`/`I4G`) are not ported yet
(ROADMAP queue 2, kernels 1-3 variants and 6, 8).
"""

from __future__ import annotations

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


class QuantizedLinearC4(NamedTuple):
    """Column-packed int4: byte [k, n] holds columns n (low nibble) and
    n + N/2 (high nibble). values (..., K, ceil(N/2) padded)."""

    values: torch.Tensor
    scale: torch.Tensor


class QuantizedLinearI4(NamedTuple):
    """Row-interleaved int4, the serving layout: byte [r, c] holds row 2r in
    its LOW nibble and row 2r+1 in its HIGH nibble. values (K/2, N_padded),
    scale (N,)."""

    values: torch.Tensor
    scale: torch.Tensor


QUANTIZED = (QuantizedLinear, QuantizedLinear4, QuantizedLinearC4,
             QuantizedLinearI4)


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


def quantize4_cols(w: torch.Tensor) -> QuantizedLinearC4:
    """Per-output-channel symmetric int4, packed along the output axis."""
    n = w.shape[-1]
    if n % 2:
        raise ValueError("column int4 packing needs even N")
    q, scale = _symmetric(w, 7.0)
    packed = _pack_nibbles(q[..., :, : n // 2], q[..., :, n // 2:])
    return QuantizedLinearC4(_pad_last(packed), scale[..., 0, :])


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
    """Chunk-major values carry two more axes than their per-channel scale
    (layer-stacked values carry one more on both)."""
    return w.values.ndim - w.scale.ndim == 2


def chunk_major(w, bc: int):
    """(K*, N) -> (N/bc, K*, bc), zero-padding N up to a multiple of ``bc``
    (the TPU serving layout of `uniaudio2_tpu.ops.quant.chunk_major`; the
    port's kernels read row-major storage). No-op for other leaves, for
    stacked or already chunked values and for N <= bc."""
    if not isinstance(w, QUANTIZED) or isinstance(w, QuantizedLinearC4):
        return w
    v = w.values
    if v.ndim != 2 or v.shape[-1] <= bc:
        return w
    if v.shape[-1] % bc:
        v = torch.nn.functional.pad(v, (0, bc - v.shape[-1] % bc))
    k_, n = v.shape
    return type(w)(v.reshape(k_, n // bc, bc).permute(1, 0, 2).contiguous(),
                   w.scale)


def dequantize(w: QuantizedLinear, dtype=torch.bfloat16) -> torch.Tensor:
    n = w.scale.shape[-1]
    return (w.values[..., :n].float() * w.scale[..., None, :]).to(dtype)


def dequantize4(w: QuantizedLinear4, dtype=torch.bfloat16) -> torch.Tensor:
    n = w.scale.shape[-1]
    lo, hi = _unpack4(w.values[..., :n])
    full = torch.cat([lo, hi], dim=-2).float()
    return (full * w.scale[..., None, :]).to(dtype)


def dequantize4_cols(w: QuantizedLinearC4, dtype=torch.bfloat16) -> torch.Tensor:
    n = w.scale.shape[-1]
    nh = n // 2
    lo, hi = _unpack4(w.values)
    full = torch.cat([lo[..., :nh], hi[..., : n - nh]], dim=-1).float()
    return (full * w.scale[..., None, :]).to(dtype)


def _interleave_rows(full: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int nibble levels -> (..., K/2, N) bytes, even row in the
    low nibble, odd row in the high one."""
    return _pack_nibbles(full[..., 0::2, :], full[..., 1::2, :])


def to_interleaved(w):
    """Serving re-layout: K-split / column-packed int4 -> row-interleaved.
    Same quantized values and scales; no-op for other leaves and for
    stacked values."""
    if isinstance(w, QuantizedLinear4):
        if w.values.ndim != 2:
            return w
        lo, hi = _unpack4(w.values)
        return QuantizedLinearI4(_interleave_rows(torch.cat([lo, hi], dim=-2)),
                                 w.scale)
    if isinstance(w, QuantizedLinearC4):
        if w.values.ndim != 2:
            return w
        n = w.scale.shape[-1]
        nh = n // 2
        lo, hi = _unpack4(w.values)
        full = torch.cat([lo[..., :nh], hi[..., : n - nh]], dim=-1)
        if n % _align(n):
            full = torch.nn.functional.pad(full, (0, _align(n) - n % _align(n)))
        return QuantizedLinearI4(_interleave_rows(full), w.scale)
    return w


def dequantize4_interleaved(w: QuantizedLinearI4,
                            dtype=torch.bfloat16) -> torch.Tensor:
    n = w.scale.shape[-1]
    lo, hi = _unpack4(w.values[..., :n])
    k2 = lo.shape[-2]
    full = torch.stack([lo, hi], dim=-2).reshape(*lo.shape[:-2], 2 * k2, n)
    return (full.float() * w.scale[..., None, :]).to(dtype)


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


def int4i_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                       residual=None):
    """Plain twin of `int4i_matmul`: x (M, K) @ dequantized I4 -> (M, N)."""
    wd = dequantize4_interleaved(QuantizedLinearI4(values, scale), x.dtype)
    return _fallback(x, wd, out_dtype, pre_norm, residual)


def int8_matmul_plain(x, values, scale, *, out_dtype=None, pre_norm=None,
                      residual=None):
    """Plain twin of `int8_matmul`: x (M, K) @ dequantized int8 -> (M, N)."""
    wd = dequantize(QuantizedLinear(values, scale), x.dtype)
    return _fallback(x, wd, out_dtype, pre_norm, residual)


GEMV_TILE_N = 64     # output columns per block of the GEMV kernels


def check_operand(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_layout(fn_name, values, scale):
    """Row-major 2-D values and a per-channel scale, on every device."""
    if scale.ndim != 1:
        raise NotImplementedError(
            "grouped-scale weights are not ported yet (ROADMAP queue 2)")
    if values.ndim != 2:
        raise ValueError(f"{fn_name}: values must be row-major 2-D, got "
                         f"{tuple(values.shape)} (chunk-major leaves are "
                         f"un-chunked by convert.from_jax at load time)")


def _launch_gemv(fn_name, rows_per_byte, x, values, scale, out_dtype,
                 pre_norm, residual):
    dev = x.device
    if x.ndim != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"{fn_name}: x must be 2-D bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    kb, ldw = values.shape
    n = scale.shape[0]
    if kb * rows_per_byte != k or ldw < n or ldw % GEMV_TILE_N:
        raise ValueError(f"{fn_name}: values {tuple(values.shape)} do not "
                         f"fit x {tuple(x.shape)} / scale ({n},)")
    check_operand(x, "x", torch.bfloat16, (m, k), dev)
    check_operand(values, "values", torch.int8, (kb, ldw), dev)
    check_operand(scale, "scale", torch.float32, (n,), dev)
    norm_w, eps = (None, 1e-5) if pre_norm is None else pre_norm
    if norm_w is not None:
        check_operand(norm_w, "norm_w", torch.bfloat16, (k,), dev)
    if residual is not None:
        check_operand(residual, "residual", torch.bfloat16, (m, n), dev)
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"{fn_name}: out_dtype {out_dtype} not supported")
    out = torch.empty((m, n), dtype=out_dtype or torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _cuda.lib()
    err = getattr(lib, fn_name)(
        _cuda.ptr(x), _cuda.ptr(values), _cuda.ptr(scale), _cuda.ptr(norm_w),
        _cuda.ptr(residual), _cuda.ptr(out), m, k, n, ldw, float(eps),
        int(out.dtype == torch.float32), _cuda.stream_of(x))
    _cuda.check(err, fn_name)
    return out


def int4i_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                 residual=None):
    """x (M, K) bf16 @ row-interleaved int4 (K/2, N_pad) * scale (N,)
    [+ residual (M, N)] -> (M, N), with an optional RMSNorm prologue
    ``pre_norm=(weight, eps)``. CUDA kernel ``ua2_gemv_int4i``
    (replaces `_pallas_int4i_matmul`, uniaudio2_tpu/ops/quant.py:948); the
    plain twin for CPU tensors."""
    _check_layout("int4i_matmul", values, scale)
    if x.device.type == "cpu":
        return int4i_matmul_plain(x, values, scale, out_dtype=out_dtype,
                                  pre_norm=pre_norm, residual=residual)
    out = _launch_gemv("ua2_gemv_int4i", 2, x, values, scale, out_dtype,
                       pre_norm, residual)
    int4i_matmul.launches += 1
    return out


int4i_matmul.launches = 0


def int8_matmul(x, values, scale, *, out_dtype=None, pre_norm=None,
                residual=None):
    """x (M, K) bf16 @ int8 (K, N_pad) * scale (N,) [+ residual] -> (M, N),
    optional RMSNorm prologue. CUDA kernel ``ua2_gemv_int8`` (replaces
    `_pallas_int8_matmul`, uniaudio2_tpu/ops/quant.py:483); the plain twin
    for CPU tensors."""
    _check_layout("int8_matmul", values, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, values, scale, out_dtype=out_dtype,
                                 pre_norm=pre_norm, residual=residual)
    out = _launch_gemv("ua2_gemv_int8", 1, x, values, scale, out_dtype,
                       pre_norm, residual)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def matmul(x: torch.Tensor, w, out_dtype=None, pre_norm=None,
           residual=None) -> torch.Tensor:
    """``x @ w`` over the last axis; ``w`` may be a plain (K, N) tensor or a
    quantized container. ``out_dtype`` forces the output dtype,
    ``pre_norm=(weight, eps)`` folds a leading RMSNorm of ``x``,
    ``residual`` (the output's shape) folds a residual add — the
    `uniaudio2_tpu.ops.quant.matmul` contract."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if isinstance(w, (QuantizedLinearI4, QuantizedLinear)):
        kernel = int4i_matmul if isinstance(w, QuantizedLinearI4) \
            else int8_matmul
        n = w.scale.shape[-1]
        res2 = None if residual is None else residual.reshape(-1, n).contiguous()
        out = kernel(x.reshape(-1, k).contiguous(), w.values, w.scale,
                     out_dtype=out_dtype, pre_norm=pre_norm, residual=res2)
        return out.reshape(*lead, -1)
    if isinstance(w, (QuantizedLinear4, QuantizedLinearC4)):
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"{type(w).__name__} has no CUDA kernel yet (ROADMAP queue 2 "
                "kernels 5 and 7); serving weights are QuantizedLinearI4 "
                "after prepare_serving_params")
        wd = (dequantize4(w, x.dtype) if isinstance(w, QuantizedLinear4)
              else dequantize4_cols(w, x.dtype))
        n = w.scale.shape[-1]
        out = _fallback(x.reshape(-1, k), wd, out_dtype, pre_norm,
                        None if residual is None else residual.reshape(-1, n))
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


def _q(w: torch.Tensor, bits: int = 8, cols: bool = False):
    if bits == 4 and cols:
        return quantize4_cols(w)
    if bits == 4:
        return quantize4(w)
    return quantize(w)


def quantize_gpt_params(params, *, bits: int = 8,
                        lm_head_bits: Optional[int] = None):
    """Quantize a GPT tree's matmul weights (layer-stacked leaves get
    per-layer scales); embeddings and norms stay as they are. The lm_head
    stays int8 even under int4; under int4 the MLP down-projection is
    column-packed. MoE expert stacks are not quantized (as in JAX)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _GPT_QUANT_LEAVES:
        if name in layers and layers[name].ndim == 3:
            layers[name] = _q(layers[name], bits,
                              cols=bits == 4 and name == "mlp_proj_w")
    out["layers"] = layers
    if "lm_head_w" in out:
        out["lm_head_w"] = _q(out["lm_head_w"], lm_head_bits or 8)
    return out


def quantize_unified_params(params, *, int4_modules: Tuple[str, ...] = (),
                            grouped: bool = False):
    """Quantize the unified model's weight matrices for serving: int4 for
    the submodules named in ``int4_modules`` ("backbone", "decoder",
    "understanding_expert", "generation_expert", "projection_w",
    "audio_head"), int8 elsewhere."""
    if grouped:
        raise NotImplementedError(
            "group-wise int4 (QuantizedLinear4G/C4G/I4G) is not ported yet "
            "(ROADMAP queue 2, grouped variants of kernels 1-3)")
    out = dict(params)
    for sub in ("backbone", "decoder", "understanding_expert",
                "generation_expert"):
        out[sub] = quantize_gpt_params(
            params[sub], bits=4 if sub in int4_modules else 8)
    out["projection_w"] = _q(params["projection_w"],
                             4 if "projection_w" in int4_modules else 8)
    out["audio_head"] = _q(params["audio_head"],
                           4 if "audio_head" in int4_modules else 8)
    return out

