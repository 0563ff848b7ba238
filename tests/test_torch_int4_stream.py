"""The host side of the TMA-ring split-K int4 GEMV (rows 11 and 13:
`ops/int4_stream.py`, `ops/int4_native.py`, `ops/int4_sweep.py`), on the
CPU: the plan of every form at the two probes' shapes and the batched
path's M, the legality of every TMA box and tensor map, the shared memory
a block takes, the form tables against the C source's, and the wrappers'
refusals, which run before any launch (on meta tensors here).

The kernel itself runs on the card only (`tests/test_torch_kernels_cuda.py`,
`chip_smoke.py` phase 3); its twins are held to the Pallas functions in
`tests/test_torch_probes_int4.py`.
"""

import re
from pathlib import Path

import pytest
import torch

from uniaudio2_tpu_torch.ops import int4_native, int4_stream, int4_sweep, quant
from uniaudio2_tpu_torch.probes import int4_native_probe, sweep_gemv_blocks

CSRC = Path(int4_stream.__file__).resolve().parents[1] / "csrc"
SMS = 132                                   # the H100 SXM's SMs
SHAPES = sorted(set(int4_native_probe.SHAPES)
                | {(k, n) for _, k, n in sweep_gemv_blocks.SHAPES})
ROWS = (1, 8, 16)


def _padded(n: int) -> int:
    """The row stride `quant.quantize4` gives an N-column weight."""
    return quant._pad_last(torch.zeros((1, n), dtype=torch.int8)).shape[1]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("form", int4_sweep.FORMS, ids=lambda f: f.name)
def test_stream_plan(form, k, n, m):
    """Every form's slices cover K/2 exactly, none empty, at most 8 (a
    portable cluster); the plan's at 64 columns are `quant.gemv_plan`'s,
    the other rules one slice or up to twice the plan's; every box and map
    is one cuTensorMapEncodeTiled takes; a block's shared memory fits; a
    chunk-major box stays inside its chunk."""
    rows = k // 2
    splits, span = int4_stream.stream_plan(m, k, n, SMS, form)
    assert 1 <= splits <= 8
    assert splits * span >= rows and (splits - 1) * span < rows
    plan = quant.gemv_plan(m, k, n, 0, quant.LAYOUT_K4, SMS)
    if form == int4_stream.DEFAULT:
        assert (splits, span) == (plan.splits, plan.span)
        # row 11's interleaved layout plans as row 13's K-split one
        assert plan == quant.gemv_plan(m, k, n, 0, quant.LAYOUT_I4, SMS)
    base = int4_stream.stream_plan(m, k, n, SMS, form._replace(slices="plan"))
    if form.slices == "one":
        assert (splits, span) == (1, rows)
    elif form.slices == "double":
        assert splits == max(c for c, _ in quant.splitk_slices(
            k, 0, quant.LAYOUT_K4) if c <= 2 * base[0])
        assert base[0] <= splits <= 2 * base[0]
    # the boxes: (bk rows x 32 bytes), unswizzled: the inner side a multiple
    # of 16 bytes, both sides at most 256; the maps' row stride a multiple
    # of 16 bytes, row-major (ldw) and chunk-major (512)
    assert int4_stream.PLANE % 16 == 0 and int4_stream.PLANE <= int4_stream.BOX_MAX
    assert form.bk <= int4_stream.BOX_MAX and form.tn % int4_stream.PLANE == 0
    assert form.bk % (int4_stream.STEP * int4_stream.CONSUMER_WARPS) == 0
    assert _padded(n) % 16 == 0 and _padded(n) >= n
    chunk = int4_native_probe.CHUNK
    assert chunk % 16 == 0 and chunk % form.tn == 0
    for col0 in range(0, _padded(n), form.tn):
        assert col0 % chunk + form.tn <= chunk
    assert int4_stream.smem_bytes(form, m, span) <= int4_stream.SMEM_CAP


def test_stream_plan_names_the_split_k_defaults():
    """Form 0 is row 11's default: 64 columns, the plan's slices, the
    conversion-free unpack; twelve forms of unique names."""
    assert int4_sweep.FORMS[int4_sweep.PRODUCTION] == int4_stream.DEFAULT
    assert int4_stream.DEFAULT.tn == quant.GEMV_TILE_N
    assert (int4_stream.DEFAULT.slices, int4_stream.DEFAULT.unpack) == (
        "plan", "magic")
    assert len(int4_sweep.FORMS) == 12
    assert len({f.name for f in int4_sweep.FORMS}) == 12
    assert len({f.name for f in int4_sweep.SIMT_FORMS}) == len(
        int4_sweep.SIMT_FORMS)


def _c_table(text: str, name: str) -> list:
    body = re.search(rf"const \w+ {name}\[\] = \{{(.*?)\n\}};", text, re.S).group(1)
    return re.findall(r"\{([^{}]*?),\s*\w+(?:::\w+)*<", body)


@pytest.mark.parametrize("table", ["FORMS", "SIMT_FORMS"])
def test_form_tables_in_the_c_order(table):
    """`FORMS` and `SIMT_FORMS` hold the C tables' forms in their order
    (`int4_sweep.check_forms` asks the built library the same on the
    card)."""
    text = (CSRC / "gemv_int4_sweep.cu").read_text()
    names = {"PLAN": 0, "ONE": 1, "DOUBLE": 2, "G": 1, "H": 0, "PS": 0,
             "PG": 1}
    rows = [tuple(names.get(v.strip(), None) if not v.strip().isdigit()
                  else int(v) for v in row.split(","))
            for row in _c_table(text, table)]
    if table == "FORMS":
        assert rows == [f.params for f in int4_sweep.FORMS]
    else:
        assert rows == [(f.cols, f.unroll, f.mt,
                         int4_stream.UNPACKS.index(f.unpack))
                        for f in int4_sweep.SIMT_FORMS]
    native = (CSRC / "gemv_int4_native.cu").read_text()
    tn, bk, stages = (int(re.search(rf"\b{v} = (\d+)", native).group(1))
                      for v in ("TN", "BK", "STAGES"))
    assert (tn, bk, stages) == int4_stream.DEFAULT[:3]


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


BF, I8, F32 = torch.bfloat16, torch.int8, torch.float32
# (x, values, scale): each one thing the kernel does not take
REFUSED = {
    "stride 72 bytes": ((1, 256, BF), (128, 72, I8), (72, F32)),
    "K odd": ((1, 255, BF), (128, 512, I8), (512, F32)),
    "x float32": ((1, 256, F32), (128, 512, I8), (512, F32)),
    "values uint8": ((1, 256, BF), (128, 512, torch.uint8), (512, F32)),
    "scale bf16": ((1, 256, BF), (128, 512, I8), (512, BF)),
    "rows short of N": ((1, 256, BF), (128, 512, I8), (520, F32)),
    "K/2 rows wrong": ((1, 256, BF), (64, 512, I8), (512, F32)),
}
REFUSED_CHUNKED = {
    "chunk of 100": ((1, 256, BF), (2, 128, 100, I8), (200, F32)),
    "chunk of 96": ((1, 256, BF), (2, 128, 96, I8), (192, F32)),
}


@pytest.mark.parametrize("wrapper,case", [
    (w, c) for w in ("native", "sweep") for c in REFUSED]
    + [("native", c) for c in REFUSED_CHUNKED])     # row 13: row-major only
def test_wrappers_refuse(wrapper, case):
    """A CUDA-side call on operands the kernel does not take raises
    ValueError before any launch (meta tensors: nothing is built)."""
    xs, vs, ss = {**REFUSED, **REFUSED_CHUNKED}[case]
    x, values, scale = _meta(*xs[:-1], dtype=xs[-1]), \
        _meta(*vs[:-1], dtype=vs[-1]), _meta(*ss[:-1], dtype=ss[-1])
    fn = (int4_native.int4_native_matmul if wrapper == "native"
          else int4_sweep.int4_sweep_matmul)
    with pytest.raises(ValueError):
        fn(x, values, scale)


def test_refusal_precedes_the_plan():
    """The checks name what is wrong; a form whose block would pass 227 KB
    of shared memory is refused by the plan before a launch."""
    x = _meta(1, 256, dtype=BF)
    with pytest.raises(ValueError, match="multiple of 16"):
        int4_stream.check_operands("t", x, _meta(128, 72, dtype=I8),
                                   _meta(72, dtype=F32), int4_stream.DEFAULT)
    with pytest.raises(ValueError, match="whole 128-column tiles"):
        int4_stream.check_operands("t", x, _meta(2, 128, 64, dtype=I8),
                                   _meta(128, dtype=F32),
                                   int4_sweep.FORMS[7])
    big = int4_stream.StreamForm(128, 128, 8, "one", "magic")
    assert int4_stream.smem_bytes(big, 16, 8192 // 2) > int4_stream.SMEM_CAP
    assert int4_stream.check_operands(
        "t", _meta(3, 8, dtype=BF), _meta(4, 64, dtype=I8),
        _meta(64, dtype=F32), int4_stream.DEFAULT) == (64, 0)
    assert int4_stream.check_operands(
        "t", _meta(3, 8, dtype=BF), _meta(2, 4, 64, dtype=I8),
        _meta(100, dtype=F32), int4_stream.DEFAULT) == (128, 64)
