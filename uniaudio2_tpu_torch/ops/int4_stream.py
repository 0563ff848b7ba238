"""The host side of the TMA-ring split-K int4 GEMV
(``csrc/gemv_int4_stream.cuh``), the design of rows 11 (`int4_native`) and
13 (`int4_sweep`): its forms, its plan, its shared memory and the checks a
wrapper makes before it launches.

A form is a point of the kernel's own parameters: ``tn`` output columns a
block (64 or 128), ``bk`` byte rows a TMA box (32, 64 or 128), ``stages``
of the ring (2-8), the slice rule (the host's plan, one slice, or twice
the plan's slices) and the unpack ("magic": the conversion-free one of the
split-K kernel; "shift": two shifts and two int -> float conversions a
byte, as `gemv_common.cuh` unpacks). The plan's slices at 64 columns are
`quant.gemv_plan`'s, so `DEFAULT` sums in the split-K kernel's order and
gives its bits at M <= 16; the slice rule alone changes a form's sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from uniaudio2_tpu_torch.ops import quant

MROWS = quant.SPLITK_MAX_M      # activation rows of a block (the MMA's 16)
PLANE = 32                      # bytes of a TMA box row
CONSUMER_WARPS = 4
STEP = 8                        # byte rows of a warp step
SMEM_CAP = 232448               # the 227 KB a block may take
BOX_MAX = 256                   # cuTensorMapEncodeTiled's largest box side
SLICE_RULES = ("plan", "one", "double")
UNPACKS = ("shift", "magic")    # csrc numbers: SHIFT 0, MAGIC 1


class StreamForm(NamedTuple):
    tn: int         # output columns a block
    bk: int         # byte rows a box (a ring stage)
    stages: int     # stages of the ring
    slices: str     # SLICE_RULES
    unpack: str     # UNPACKS

    @property
    def name(self) -> str:
        return (f"t{self.tn}k{self.bk}s{self.stages}-{self.slices}-"
                f"{self.unpack}")

    @property
    def params(self) -> Tuple[int, int, int, int, int]:
        """The form as the C tables hold it."""
        return (self.tn, self.bk, self.stages, SLICE_RULES.index(self.slices),
                UNPACKS.index(self.unpack))


DEFAULT = StreamForm(64, 64, 4, "plan", "magic")      # row 11's form


def stream_plan(m: int, k: int, n: int, sms: int,
                form: StreamForm = DEFAULT) -> Tuple[int, int]:
    """(K-slices, byte rows a slice) of a call of ``m`` rows, contraction
    width ``k`` and ``n`` output columns in ``form`` on a card of ``sms``
    SMs, for either row-packed layout (per channel, `quant.gemv_plan`
    plans I4 and K4 alike). The plan's slices: `quant.gemv_plan` at 64
    columns and up to `quant.SPLITK_MAX_M` rows; otherwise its rule (the slice count whose
    grid comes nearest `quant.SPLITK_BLOCKS_PER_SM` blocks an SM, the fewer
    on a tie) over this form's column tiles and every tile of 16 rows. The
    rule "one" takes all of K in one slice, "double" the most slices up to
    twice the plan's (`quant.splitk_slices`: none empty)."""
    if form.tn == quant.GEMV_TILE_N and m <= quant.SPLITK_MAX_M:
        p = quant.gemv_plan(m, k, n, 0, quant.LAYOUT_K4, sms)
        s, span = p.splits, p.span
    else:
        tiles = -(-n // form.tn) * -(-m // MROWS)
        want = quant.SPLITK_BLOCKS_PER_SM * sms
        s, span = min(quant.splitk_slices(k, 0, quant.LAYOUT_K4),
                      key=lambda c: (abs(math.log(tiles * c[0] / want)), c[0]))
    if form.slices == "one":
        return 1, k // 2
    if form.slices == "double":
        return max((c for c in quant.splitk_slices(k, 0, quant.LAYOUT_K4)
                    if c[0] <= 2 * s), key=lambda c: c[0])
    return s, span


def staged_rows(span: int) -> int:
    """Words between two staged activation rows (splitk::staged_rows)."""
    return -(-span // 32) * 32 + 4


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(form: StreamForm, m: int, span: int) -> int:
    """Dynamic shared bytes of a launch (gemv_int4_stream.cuh
    `smem_bytes`): alignment slack, the ring (or, after the loop, the four
    warps' partial tiles), 8 or 16 staged activation rows, the block's
    partial tile, the tile's scales, the mbarriers."""
    ring = form.stages * form.bk * form.tn
    red = CONSUMER_WARPS * MROWS * (form.tn + 1) * 4
    mr = 16 if m > 8 else 8
    return (128 + _align16(max(ring, red)) + _align16(mr * staged_rows(span) * 4)
            + (MROWS + 1) * form.tn * 4 + 16 * form.stages)


def check_operands(name: str, x: torch.Tensor, values: torch.Tensor,
                   scale: torch.Tensor, form: StreamForm) -> Tuple[int, int]:
    """Raise ValueError unless the kernel takes these operands in ``form``:
    x (M, K) bf16, K even; ``values`` int8 (K/2, ldw) row-major or (C, K/2,
    bn) chunk-major, contiguous, 16-byte aligned, the row stride (ldw or
    bn) a multiple of 16 bytes (a TMA map's), wide enough for N, a chunk a
    whole number of tiles; scale (N,) f32; all on x's device. Runs before
    any launch, on any device. Returns (ldw, bn): the padded width and the
    chunk width (0: row-major)."""
    if x.ndim != 2 or x.shape[1] % 2:
        raise ValueError(f"{name}: x must be (M, K) with K even, got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    n = scale.shape[-1]
    dev = x.device
    quant.check_operand(x, "x", torch.bfloat16, (m, k), dev)
    quant.check_operand(values, "values", torch.int8, tuple(values.shape), dev)
    quant.check_operand(scale, "scale", torch.float32, (n,), dev)
    if values.ndim not in (2, 3) or values.shape[-2] * 2 != k:
        raise ValueError(f"{name}: values {tuple(values.shape)} do not hold "
                         f"K = {k}")
    bn = values.shape[2] if values.ndim == 3 else 0
    ldw = values.shape[0] * bn if bn else values.shape[1]
    stride = bn or ldw
    if stride % 16 or ldw < n:
        raise ValueError(f"{name}: rows of {stride} bytes (a multiple of 16 "
                         f"for the tensor map) must hold N = {n}")
    if bn and bn % form.tn:
        raise ValueError(f"{name}: chunks of {bn} columns do not hold whole "
                         f"{form.tn}-column tiles")
    if dev.type == "cuda" and values.data_ptr() % 16:
        raise ValueError(f"{name}: values must be 16-byte aligned")
    return ldw, bn


def plan_launch(name: str, m: int, k: int, n: int, form: StreamForm,
                device: torch.device) -> Tuple[int, int]:
    """The plan of a launch on ``device`` (`stream_plan`), refused when
    its shared memory passes the 227 KB a block may take."""
    sms = quant._sm_count(device)
    splits, span = stream_plan(m, k, n, sms, form)
    smem = smem_bytes(form, m, span)
    if smem > SMEM_CAP:
        raise ValueError(f"{name}: form {form.name} at (M, K) = ({m}, {k}) "
                         f"needs {smem} bytes of shared memory a block, over "
                         f"{SMEM_CAP}")
    return splits, span
