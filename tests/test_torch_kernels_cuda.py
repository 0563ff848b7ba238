"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where there is no CUDA device (the card is checked
inside a fixture, never at import). On a machine with the card and no JAX,
run them without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: |kernel - twin| <= 2e-2 * max|twin|. The kernels follow the
Pallas math (unscaled int weights dotted in f32, scale and residual on the
f32 sum, one rounding to the output dtype); the twins follow the JAX
fallback (scale folded into a bf16-rounded weight, bf16 rounding of the
product before the residual and of gate/up in the MLP). Each of those
roundings is a relative 2^-9 (0.2 %); a few of them stacked, at the worst
element of a tile, stay below 2 % of the output's range. The flash
attention kernel rounds the unnormalised probabilities to bf16 where its
twin rounds the normalised ones (one 2^-9 each), within the same bound.
The grouped-scale GEMVs (`int4ig`, `int4g`, `int4cg`) scale and round each
weight to bf16 before the product exactly as their twins do, so without a
residual the two differ only in the order of the f32 sum and land within
one bf16 ulp of each other: 2^-7 x max|twin| (RTOL_GROUPED).
The split-K int8 GEMV and its twin add exact f32 products in another
order and round once, so they too agree within RTOL_GROUPED; the causal
GQA flash form keeps the flash kernel's 2e-2. Both flash forms are held
row by row (each query row to 2e-2 x its own max|twin|): a causal row i
averages i + 1 values and is ~sqrt(1 / i) the size of row 0. The float32
flash kernel and its twin keep every product in f32 and sum in another
order: rows within 1e-5 x their max|twin| (the kernel's three TF32
products keep ~22 bits of each operand); so does the first float32 design
on the CUDA cores, `flash_attention_f32_simt`.
Row 3 (the fused QKV step) at decode runs the split-K kernel's QKV mode
with the host's plan: every form at both model widths and M = 1-17 within
2e-2 x max|twin|, bit-identical from call to call, one kernel node in a
captured graph; the first design, `qkv_rope_step_tiled`, within the same
bound.
The two int4 probe kernels (rows 11 and 13: the TMA-ring split-K GEMV of
`csrc/gemv_int4_stream.cuh`, row 11 in its default form, row 13 in twelve
forms) add exact f32 products in another order than their twins and
round once: one bf16 ulp (RTOL_GROUPED). On the split-K kernel's plan
they sum in its order, so at M <= 16 row 11 gives `int4i_matmul`'s bits
(row-major and chunk-major alike) and row 13's form 0 `int4_matmul`'s,
and every form on form 0's slices form 0's bits. Their first designs
(`int4_native_matmul_simt`, `int4_sweep_matmul_simt`: CUDA-core FMAs in
the tiled template's order) give the tiled instances' bits
(`int4i_matmul_tiled`, `int4_matmul_tiled`).
Rows 1, 5 and 6 at decode (M <= 16) run the split-K cluster kernel with the
host's plan (`quant.gemv_plan`): held to their twins with the bounds
above at the decode shapes and at the prefill's M (the tensor-core tile
kernel), bit-identical from
launch to launch, one kernel node in a captured graph. Rows 1, 5 and 6 above
16 rows run the tile kernel of `quant.tc_plan` with the norm and the
residual their served callers fold, one counted launch of it a call (a
norm, and the K-split layout, add its row kernel), and a planted fault
(the K-split halves swapped) fails the same check. The fused SwiGLU (row
2) runs two split-K passes up to 16 rows and the two tiled passes above,
in every served form at both widths, with and without the norm and the
residual: within 2e-2 x max|twin| (the twin rounds a, b and every scaled
weight to bf16), one counted launch a call, the same bits from call to
call, two kernel nodes in a captured graph. Above 16 rows it runs the two
tile passes (pass 1 `swiglu_tc_kernel`, pass 2 the tile GEMV of W3's
layout), each counted once a call (`fused_mlp.swiglu_tc`, `quant.gemv_tc`
under W3's form), and a K-split tree gives its interleaved copy's bits,
h and the output. Row 14's stacked-layer kernel, with the layer index read
on the device, is held to its twin within one bf16 ulp and to the bits
of `gemv_int4.cu`'s tiled instance on every layer's slice.
The lean-update kernel rounds every operation as its twin does, so the two
must agree to the bit. `quant.matmul`'s bf16 tensor-core product (the
training forward's) is held to its float32 form: both sum in float32 in
another order and round once to bf16, so they differ by one bf16 ulp
(at most 2^-7 of the value) plus the float32 sums' order and the tensor
cores' accumulation, 1e-3 x max|ref|.
"""

import pytest
import torch

from uniaudio2_tpu_torch.ops import (
    _cuda, flash_attention, fused_mlp, int4_native, int4_stacked, int4_stream,
    int4_sweep, lean_update, qkv_step, quant, splitk_gemv,
)
from uniaudio2_tpu_torch.probes import int4_native_probe
from uniaudio2_tpu_torch.train import lean_opt

pytestmark = pytest.mark.cuda
RTOL = 2e-2
RTOL_GROUPED = 2.0 ** -7


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _bf16(gen, dev, *shape, std=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)


def _i4(gen, dev, k, n, cols=False):
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    q = quant.quantize4_cols(w) if cols else quant.quantize4(w)
    return quant.to_interleaved(q)


def _make(gen, dev, form, k, n, group=128):
    """A random (k, n) weight in the container of ``form`` (the JAX
    package's mode names)."""
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    if form == "int8":
        return quant.quantize(w)
    q = {"int4": quant.quantize4, "int4i": quant.quantize4,
         "int4c": quant.quantize4_cols}.get(form)
    if q is None:
        q = {"int4g": quant.quantize4_grouped, "int4ig": quant.quantize4_grouped,
             "int4cg": quant.quantize4_cols_grouped}[form]
        w = q(w, group)
    else:
        w = q(w)
    return quant.to_interleaved(w) if form in ("int4i", "int4ig") else w


def _close(out, ref, rtol=RTOL):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    bound = rtol * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


def _close_rows(out, ref, rtol=RTOL):
    """`_close` per row (last axis): each row within ``rtol`` x its own
    max|ref|. Causal attention's late rows average many values and are far
    smaller than row 0, a copy of v[0]."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    d, mag = (out.float() - ref.float()).abs(), ref.float().abs()
    worst = (d.amax(-1) / mag.amax(-1)).max().item()
    assert worst <= rtol, worst


FOLDS = [(False, False, None), (True, False, None), (False, True, None),
         (True, True, torch.float32)]


@pytest.mark.parametrize("m", [1, 2, 63, 130])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
def test_int4i_matmul(dev, m, norm, res, out_dtype):
    g = _gen(dev)
    k, n = 512, 600                          # stored 1024 wide
    w = _i4(g, dev, k, n)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = quant.int4i_matmul.launches
    out = quant.int4i_matmul(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    assert quant.int4i_matmul.launches == before + 1
    _close(out, quant.int4i_matmul_plain(x, w.values, w.scale, **kw))


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 63, 126, 130, 255, 510])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
def test_int8_matmul(dev, m, norm, res, out_dtype):
    """Row 4 with every fold: up to 16 rows the split-K kernel, above them
    the tile kernel (one count of its "int8" form a call, none of the tiled
    yardstick); within 2e-2 x max|twin|, the same bits twice."""
    g = _gen(dev, 1)
    k, n = 384, 1000
    w = quant.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = (quant.int8_matmul.launches, quant.int8_matmul_tiled.launches,
              quant.gemv_tc.forms.get("int8", 0))
    out = quant.int8_matmul(x, w.values, w.scale, **kw)
    again = quant.int8_matmul(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    tile = 2 if m > quant.SPLITK_MAX_M else 0
    assert (quant.int8_matmul.launches, quant.int8_matmul_tiled.launches,
            quant.gemv_tc.forms.get("int8", 0)) == (
        before[0] + 2, before[1], before[2] + tile)
    assert torch.equal(out, again)
    _close(out, quant.int8_matmul_plain(x, w.values, w.scale, **kw))


@pytest.mark.parametrize("m", [1, 63])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
def test_int8_matmul_tiled_yardstick(dev, m, norm, res, out_dtype):
    """Row 4's first design, `int8_matmul_tiled`, with every fold: within
    2e-2 x max|twin|, counted on its own."""
    g = _gen(dev, 2)
    k, n = 384, 1000
    w = quant.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = (quant.int8_matmul.launches, quant.int8_matmul_tiled.launches,
              quant.gemv_tc.forms.get("int8", 0))
    out = quant.int8_matmul_tiled(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    assert (quant.int8_matmul.launches, quant.int8_matmul_tiled.launches,
            quant.gemv_tc.forms.get("int8", 0)) == (before[0], before[1] + 1,
                                                    before[2])
    _close(out, quant.int8_matmul_plain(x, w.values, w.scale, **kw))


@pytest.mark.parametrize("m", [1, 2, 16])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
def test_int8_matmul_wide_n(dev, m, norm, res, out_dtype):
    """Row 4 over an output wide enough for the split-K kernel's wide-N
    instance (the lm_head's kind: 301 tiles of 256 columns on 132 SMs;
    ragged past the last whole tile, stored 512 wider): the plan names it,
    and the output is within 2e-2 x max|twin|, the same bits twice."""
    g = _gen(dev, 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k, n = 256, 256 * int(quant.SPLITK_BLOCKS_PER_SM * sms + 4) + 100
    w = quant.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    assert quant.gemv_plan(m, k, n, 0, quant.LAYOUT_INT8, sms,
                           wide=True).tile == quant.SPLITK_WIDE_N
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = quant.int8_matmul.launches
    out = quant.int8_matmul(x, w.values, w.scale, **kw)
    again = quant.int8_matmul(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 2
    assert torch.equal(out, again)
    _close(out, quant.int8_matmul_plain(x, w.values, w.scale, **kw))


GEMV_FORMS = {"int8": quant.int8_matmul, "int4i": quant.int4i_matmul,
              "int4ig": quant.int4i_matmul, "int4": quant.int4_matmul,
              "int4g": quant.int4g_matmul, "int4c": quant.int4c_matmul,
              "int4cg": quant.int4cg_matmul}


@pytest.mark.parametrize("m", [1, 2, 63, 130])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
@pytest.mark.parametrize("form", list(GEMV_FORMS))
def test_matmul_every_form(dev, form, m, norm, res, out_dtype):
    """`quant.matmul` sends every container to its kernel (one launch) and
    agrees with the dequantize-then-product twin; odd widths exercise the
    padded storage and, for the column-packed forms, both trims."""
    g = _gen(dev, 9)
    k, n = 512, 600
    w = _make(g, dev, form, k, n, group=64)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = GEMV_FORMS[form].launches
    out = quant.matmul(x, w, **kw)
    torch.cuda.synchronize()
    assert GEMV_FORMS[form].launches == before + 1
    grouped_plain = form.endswith("g") and not res
    _close(out, quant.matmul_plain(x, w, **kw),
           RTOL_GROUPED if grouped_plain else RTOL)


@pytest.mark.parametrize("k", [64, 192, 320])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
@pytest.mark.parametrize("form", list(GEMV_FORMS))
def test_matmul_launches_at_any_width(dev, form, k, norm, res, out_dtype):
    """Contraction widths the JAX dispatcher hands to its dequantize-then-
    product form (`kernel_eligible` false: K not a multiple of 256, or of
    128 for int8 and the column-packed forms) still launch the container's
    kernel on the card, once, and agree with the twin."""
    g = _gen(dev, 12)
    n, m = 200, 3
    w = _make(g, dev, form, k, n, group=32)
    assert not quant.kernel_eligible(w, k)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    before = GEMV_FORMS[form].launches
    out = quant.matmul(x, w, **kw)
    torch.cuda.synchronize()
    assert GEMV_FORMS[form].launches == before + 1
    grouped_plain = form.endswith("g") and not res
    _close(out, quant.matmul_plain(x, w, **kw),
           RTOL_GROUPED if grouped_plain else RTOL)


@pytest.mark.parametrize("form", ["int8", "int4", "int4g", "int4i", "int4ig"])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("h,g_,hd", [(8, 4, 64), (4, 2, 128)])
def test_qkv_rope_step_every_mode(dev, form, b, h, g_, hd):
    g = _gen(dev, 10)
    k = 512
    w = _make(g, dev, form, k, (h + 2 * g_) * hd, group=64)
    x = _bf16(g, dev, b, k)
    nw = _bf16(g, dev, k)
    ang = torch.rand(hd // 2, generator=g, device=dev) * 6.0
    cos = torch.cos(torch.cat([ang, ang]))
    sin = torch.sin(torch.cat([ang, ang]))
    assert qkv_step.can_fuse(w, x, h, g_, hd)
    before = qkv_step.qkv_rope_step.forms.get(form, 0)
    out = qkv_step.qkv_rope_step(x, w, nw, 1e-5, cos, sin, h, g_, hd)
    torch.cuda.synchronize()
    assert qkv_step.qkv_rope_step.forms[form] == before + 1
    ref = qkv_step.qkv_rope_step_plain(x, w, nw, 1e-5, cos, sin, h, g_, hd)
    for o, r in zip(out, ref):
        _close(o, r)


QKV_WIDTHS = {"backbone": (3072, 24, 8, 128), "decoder": (2048, 32, 8, 64)}


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17])
@pytest.mark.parametrize("width", list(QKV_WIDTHS))
@pytest.mark.parametrize("form", ["int4i", "int4ig", "int4", "int4g", "int8"])
def test_qkv_rope_step_at_decode(dev, form, width, m):
    """Row 3 at the model's widths: up to 16 rows the split-K kernel's QKV
    mode, above them the first design; within 2e-2 x max|twin| on q, k and
    v, two calls the same bits, one count a call; the first design
    (`qkv_rope_step_tiled`, counted on its own) held to the twin too."""
    g = _gen(dev, 30)
    k, h, g_, hd = QKV_WIDTHS[width]
    w = _make(g, dev, form, k, (h + 2 * g_) * hd)
    x = _bf16(g, dev, m, k)
    nw = (1.0 + 0.1 * torch.randn(k, generator=g, device=dev)).to(torch.bfloat16)
    ang = torch.rand(hd // 2, generator=g, device=dev) * 6.0
    cos = torch.cos(torch.cat([ang, ang]))
    sin = torch.sin(torch.cat([ang, ang]))
    args = (x, w, nw, 1e-5, cos, sin, h, g_, hd)
    assert qkv_step.can_fuse(w, x, h, g_, hd)
    before = qkv_step.qkv_rope_step.forms.get(form, 0)
    tiled = qkv_step.qkv_rope_step_tiled.forms.get(form, 0)
    out, again = qkv_step.qkv_rope_step(*args), qkv_step.qkv_rope_step(*args)
    first = qkv_step.qkv_rope_step_tiled(*args)
    torch.cuda.synchronize()
    assert qkv_step.qkv_rope_step.forms[form] == before + 2
    assert qkv_step.qkv_rope_step_tiled.forms[form] == tiled + 1
    ref = qkv_step.qkv_rope_step_plain(*args)
    for o, a, f, r in zip(out, again, first, ref):
        assert torch.equal(o, a)
        _close(o, r)
        _close(f, r)


@pytest.mark.parametrize("m", [1, 16])
def test_qkv_rope_step_is_one_graph_node(dev, m, tmp_path):
    """At decode one call captured in a CUDA graph is one kernel node, the
    split-K kernel's QKV instance, and its replay gives the eager bits."""
    g = _gen(dev, 31)
    k, h, g_, hd = QKV_WIDTHS["backbone"]
    w = _make(g, dev, "int4i", k, (h + 2 * g_) * hd)
    x = _bf16(g, dev, m, k)
    nw = _bf16(g, dev, k)
    cos, sin = (torch.rand(hd, generator=g, device=dev) for _ in range(2))
    args = (x, w, nw, 1e-5, cos, sin, h, g_, hd)
    ref = qkv_step.qkv_rope_step(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qkv_step.qkv_rope_step(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = qkv_step.qkv_rope_step(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    dot = tmp_path / "graph.dot"
    graph.debug_dump(str(dot))
    kernels = [line for line in dot.read_text().splitlines()
               if "kernel" in line and ("gemv_" in line or "qkv_" in line)]
    assert len(kernels) == 1, kernels
    assert "18gemv_splitk_kernelILi1ELb0ELi3E" in kernels[0] or \
        "gemv_splitk_kernel<1, false, 3>" in kernels[0], kernels


SWIGLU_FORMS = [(a, b) for a in ("int8", "int4", "int4g")
                for b in ("int8", "int4c", "int4cg")] \
    + [(a, b) for a in ("int4i", "int4ig") for b in ("int8", "int4i", "int4ig")]


@pytest.mark.parametrize("m", [1, 63])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("up,down", SWIGLU_FORMS)
def test_fused_swiglu_every_form(dev, up, down, m, folded):
    g = _gen(dev, 11)
    k, i, n = 512, 1024, 520
    w1, w2 = _make(g, dev, up, k, i, 64), _make(g, dev, up, k, i, 64)
    w3 = _make(g, dev, down, i, n, 64)
    x = _bf16(g, dev, m, k)
    kw = dict(norm_w=_bf16(g, dev, k), residual=_bf16(g, dev, m, n)) \
        if folded else {}
    assert fused_mlp.can_fuse(w1, w2, w3, x)
    before = fused_mlp.fused_swiglu.forms.get(f"{up}+{down}", 0)
    out = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
    torch.cuda.synchronize()
    assert fused_mlp.fused_swiglu.forms[f"{up}+{down}"] == before + 1
    _close(out, fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw))


@pytest.mark.parametrize("b", [1, 2, 5])
@pytest.mark.parametrize("h,g_,hd", [(8, 4, 64), (4, 2, 128)])
def test_qkv_rope_step(dev, b, h, g_, hd):
    g = _gen(dev, 2)
    k = 512
    w = _i4(g, dev, k, (h + 2 * g_) * hd)
    x = _bf16(g, dev, b, k)
    nw = _bf16(g, dev, k)
    ang = torch.rand(hd // 2, generator=g, device=dev) * 6.0
    cos = torch.cos(torch.cat([ang, ang]))
    sin = torch.sin(torch.cat([ang, ang]))
    assert qkv_step.can_fuse(w, x, h, g_, hd)
    out = qkv_step.qkv_rope_step(x, w, nw, 1e-5, cos, sin, h, g_, hd)
    torch.cuda.synchronize()
    ref = qkv_step.qkv_rope_step_plain(x, w, nw, 1e-5, cos, sin, h, g_, hd)
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("m", [1, 2, 63])
@pytest.mark.parametrize("folded", [False, True])
def test_fused_swiglu(dev, m, folded):
    g = _gen(dev, 3)
    k, i, n = 512, 1024, 520
    w1, w2 = _i4(g, dev, k, i), _i4(g, dev, k, i)
    w3 = _i4(g, dev, i, n, cols=True)
    x = _bf16(g, dev, m, k)
    kw = dict(norm_w=_bf16(g, dev, k), residual=_bf16(g, dev, m, n)) \
        if folded else {}
    assert fused_mlp.can_fuse(w1, w2, w3, x)
    out = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
    torch.cuda.synchronize()
    _close(out, fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw))


@pytest.mark.parametrize("b,h,t,hd", [(2, 24, 186, 64), (2, 24, 374, 64),
                                       (2, 24, 750, 64), (1, 24, 130, 64),
                                       (2, 4, 1, 64), (1, 8, 200, 128)])
def test_flash_attention(dev, b, h, t, hd):
    g = _gen(dev, 5)
    q, k, v = (_bf16(g, dev, b, h, t, hd) for _ in range(3))
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, hd ** -0.5)
    again = flash_attention.flash_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 2
    assert torch.equal(out, again)                  # no atomics: the same bits
    _close_rows(out, flash_attention.attention_plain(q, k, v, hd ** -0.5))


@pytest.mark.parametrize("t", [1, 63, 127, 128, 129, 255, 257])
@pytest.mark.parametrize("b,h,g_", [(2, 3, 3), (1, 4, 2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_every_instantiation(dev, hd, causal, b, h, g_, t):
    """Each of the four kernels (hd 64 with 64-row query tiles, hd 128 with
    128-row tiles; causal or not), with K/V groups equal to the heads and
    fewer, at T = 1, around the 128-key stage (BK +- 1) and around two
    query tiles (2 BQ +- 1): rows within 2e-2 x their max|twin|, two
    launches the same bits; the layout the kernel reports fits the 227 KB
    a block may take."""
    bq = flash_attention.flash_plan(b, h, g_, t, hd).bq
    bk, stages, smem = flash_attention.flash_layout(hd, bq)
    assert (bq, bk) == (hd, 128) and stages >= 2 and smem <= 232_448
    g = _gen(dev, 8)
    q = _bf16(g, dev, b, h, t, hd)
    k, v = (_bf16(g, dev, b, g_, t, hd) for _ in range(2))
    out = flash_attention.flash_attention(q, k, v, hd ** -0.5, causal=causal)
    again = flash_attention.flash_attention(q, k, v, hd ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close_rows(out, flash_attention.attention_plain(q, k, v, hd ** -0.5,
                                                     causal=causal))


@pytest.mark.parametrize("t", [1, 15, 63, 64, 65, 130, 186, 374, 750])
@pytest.mark.parametrize("b,h,g_", [(2, 24, 24), (1, 4, 2)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_f32(dev, hd, b, h, g_, t):
    """The float32 kernel (`csrc/flash_attn_f32.cu`, non-causal, 3xTF32 on
    the tensor cores), K/V groups equal to the heads and fewer, at the
    codec windows' T and around its 64-row query and key tiles: rows within
    1e-5 x their max|twin| (the kernel's products keep ~22 bits of each
    operand, both sum in f32 in another order), on the card and on the
    CPU, one launch a call counted as the form "f32", two launches the same
    bits. TF32 off for the twin's products."""
    g = _gen(dev, 9)
    q = torch.randn((b, h, t, hd), generator=g, device=dev)
    k, v = (torch.randn((b, g_, t, hd), generator=g, device=dev)
            for _ in range(2))
    before = flash_attention.flash_attention.forms.get("f32", 0)
    out = flash_attention.flash_attention(q, k, v, hd ** -0.5)
    again = flash_attention.flash_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.forms["f32"] == before + 2
    assert torch.equal(out, again)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = flash_attention.attention_plain(q, k, v, hd ** -0.5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    _close_rows(out, ref, rtol=1e-5)
    cpu = flash_attention.attention_plain(q.cpu(), k.cpu(), v.cpu(), hd ** -0.5)
    _close_rows(out.cpu(), cpu, rtol=1e-5)


@pytest.mark.parametrize("t", [1, 63, 186, 750])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_f32_simt(dev, hd, t):
    """The first float32 design (f32 FMAs on the CUDA cores), the
    yardstick: rows within 1e-5 x their max|twin|, counted on its own,
    never as the wrapper's form "f32"."""
    g = _gen(dev, 19)
    q, k, v = (torch.randn((2, 24, t, hd), generator=g, device=dev)
               for _ in range(3))
    before = (flash_attention.flash_attention_f32_simt.launches,
              flash_attention.flash_attention.forms.get("f32", 0))
    out = flash_attention.flash_attention_f32_simt(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_f32_simt.launches,
            flash_attention.flash_attention.forms.get("f32", 0)) == (
                before[0] + 1, before[1])
    cpu = flash_attention.attention_plain(q.cpu(), k.cpu(), v.cpu(), hd ** -0.5)
    _close_rows(out.cpu(), cpu, rtol=1e-5)


@pytest.mark.parametrize("b,h,g_,t,hd", [(1, 24, 8, 2048, 128), (1, 24, 8, 1000, 128),
                                          (1, 4, 2, 130, 128), (2, 6, 3, 77, 64),
                                          (1, 8, 8, 64, 64), (1, 2, 1, 1, 128)])
def test_flash_attention_causal_gqa(dev, b, h, g_, t, hd):
    """The causal form with K/V heads mapped in place (h -> h / (H / G)),
    T not a multiple of the 128-key stage included; two launches the same
    bits."""
    g = _gen(dev, 6)
    q = _bf16(g, dev, b, h, t, hd)
    k, v = (_bf16(g, dev, b, g_, t, hd) for _ in range(2))
    before = dict(flash_attention.flash_attention.forms)
    out = flash_attention.flash_attention(q, k, v, hd ** -0.5, causal=True)
    again = flash_attention.flash_attention(q, k, v, hd ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.forms["causal"] == \
        before.get("causal", 0) + 2
    assert torch.equal(out, again)
    _close_rows(out, flash_attention.attention_plain(q, k, v, hd ** -0.5,
                                                     causal=True))


@pytest.mark.parametrize("k,n", [(3072, 8192), (8192, 3072), (2048, 8192),
                                 (3072, 5120), (3072, 3072), (2048, 4096),
                                 (256, 700), (96, 40), (2080, 1300)])
def test_int8_splitk_gemv(dev, k, n):
    """The split-K GEMV against its twin: both sum exact f32 products in
    another order and round once, so one bf16 ulp, 2^-7 x max|twin|."""
    g = _gen(dev, 7)
    w = quant.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    x = _bf16(g, dev, 1, k)
    before = splitk_gemv.int8_splitk_gemv.launches
    out = splitk_gemv.int8_splitk_gemv(x, w.values, w.scale)
    torch.cuda.synchronize()
    assert splitk_gemv.int8_splitk_gemv.launches == before + 1
    ref = splitk_gemv.int8_splitk_gemv_plain(x, w.values, w.scale)
    assert out.shape == ref.shape == (1, n) and out.dtype == torch.bfloat16
    _close(out, ref, rtol=RTOL_GROUPED)
    # the same function as the production int8 kernel, within its bound
    _close(out, quant.int8_matmul_plain(x, w.values, w.scale))
    again = splitk_gemv.int8_splitk_gemv(x, w.values, w.scale)
    assert torch.equal(out, again)                  # fixed-order sums


NATIVE_SHAPES = [(256, 512), (512, 1024), (3072, 8192), (2048, 12300)]


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("k,n", NATIVE_SHAPES)
def test_int4_native_gemv(dev, k, n, m):
    """Row 11's kernel (the TMA-ring split-K GEMV): its twin within one
    bf16 ulp, row-major and chunk-major bit for bit, and at M <= 16 the
    split-K kernel's bits (`quant.int4i_matmul`, the same plan); one
    counted launch a call."""
    g = _gen(dev, k + m)
    w = _i4(g, dev, k, n)
    x = _bf16(g, dev, m, k)
    before = int4_native.int4_native_matmul.launches
    out = int4_native.int4_native_matmul(x, w.values, w.scale)
    chunked = int4_native.int4_native_matmul(
        x, int4_native_probe.chunk_major(w.values, 512), w.scale)
    torch.cuda.synchronize()
    assert int4_native.int4_native_matmul.launches == before + 2
    _close(out, int4_native.int4_native_matmul_plain(x, w.values, w.scale),
           rtol=RTOL_GROUPED)
    assert torch.equal(out, chunked)
    if m <= quant.SPLITK_MAX_M:
        assert torch.equal(out, quant.int4i_matmul(x, w.values, w.scale))


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("k,n", NATIVE_SHAPES)
def test_int4_native_gemv_simt(dev, k, n, m):
    """Row 11's first design: its twin within one bf16 ulp, the tiled
    instance of the production row-interleaved kernel to the bit, row-major
    and chunk-major alike; counted on its own."""
    g = _gen(dev, k + m)
    w = _i4(g, dev, k, n)
    x = _bf16(g, dev, m, k)
    before = int4_native.int4_native_matmul_simt.launches
    out = int4_native.int4_native_matmul_simt(x, w.values, w.scale)
    chunked = int4_native.int4_native_matmul_simt(
        x, int4_native_probe.chunk_major(w.values, 512), w.scale)
    torch.cuda.synchronize()
    assert int4_native.int4_native_matmul_simt.launches == before + 2
    _close(out, int4_native.int4_native_matmul_plain(x, w.values, w.scale),
           rtol=RTOL_GROUPED)
    assert torch.equal(out, chunked)
    assert torch.equal(out, quant.int4i_matmul_tiled(x, w.values, w.scale))


SPLITK_FORMS = {"int4i": quant.int4i_matmul, "int4ig": quant.int4i_matmul,
                "int4": quant.int4_matmul, "int4g": quant.int4g_matmul,
                "int8": quant.int8_matmul}
# the decode shapes of rows 1, 4, 5 and 6: (K, N, residual, f32 out)
SPLITK_SHAPES = {"attn_proj": (3072, 3072, True, False),
                 "decoder attn_proj": (2048, 2048, True, False),
                 "audio_head": (2048, 12300, False, True),
                 "projection": (3072, 2048, False, False)}


@pytest.mark.parametrize("m", [1, 2, 8, 16, 63, 255])
@pytest.mark.parametrize("shape", list(SPLITK_SHAPES))
@pytest.mark.parametrize("form", list(SPLITK_FORMS))
def test_int4_decode_gemv(dev, form, shape, m):
    """Rows 1 (per-channel and grouped), 4, 5 and 6 at their decode shapes (the
    split-K kernel, M <= 16) and the prefill's M (the tile kernel), as
    the path calls them and with the
    other folds (norm, residual, f32 out):
    within the twin's bound, one counted launch a call, the same bits from
    launch to launch."""
    g = _gen(dev, 21)
    k, n, res, f32 = SPLITK_SHAPES[shape]
    w = _make(g, dev, form, k, n)
    x = _bf16(g, dev, m, k)
    fn = SPLITK_FORMS[form]
    for norm, with_res, out_dtype in ((False, res, torch.float32 if f32 else None),
                                      (True, not res, None if f32 else torch.float32)):
        kw = dict(out_dtype=out_dtype,
                  pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
                  residual=_bf16(g, dev, m, n, std=0.1) if with_res else None)
        before = fn.launches
        out = fn(x, w.values, w.scale, **kw)
        again = fn(x, w.values, w.scale, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert torch.equal(out, again)
        grouped_plain = form.endswith("g") and not with_res
        _close(out, quant.matmul_plain(x, w, **kw),
               RTOL_GROUPED if grouped_plain else RTOL)


@pytest.mark.parametrize("form", list(SPLITK_FORMS))
def test_int4_decode_gemv_is_one_graph_node(dev, form, tmp_path):
    """One call captured in a CUDA graph is one kernel node, the split-K
    kernel's, and its replay gives the eager call's bits."""
    g = _gen(dev, 22)
    w = _make(g, dev, form, 3072, 2048)
    x = _bf16(g, dev, 1, 3072)
    ref = SPLITK_FORMS[form](x, w.values, w.scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        SPLITK_FORMS[form](x, w.values, w.scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = SPLITK_FORMS[form](x, w.values, w.scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    dot = tmp_path / "graph.dot"
    graph.debug_dump(str(dot))
    lines = dot.read_text().splitlines()
    kernels = [line for line in lines if "gemv_" in line and "kernel" in line]
    assert len(kernels) == 1 and "gemv_splitk_kernel" in kernels[0], kernels


def test_int4_sweep_form_table(dev):
    int4_sweep.check_forms()


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("form", range(len(int4_sweep.FORMS)))
def test_int4_sweep_gemv(dev, form, m):
    """Row 13's kernel (the TMA-ring split-K GEMV) in every form at the
    backbone's qkv and the audio head (N = 12300, a partial last tile): its
    twin within one bf16 ulp; a form on form 0's slices gives form 0's
    bits, and form 0 at M <= 16 the split-K K4 kernel's
    (`quant.int4_matmul`, the same plan); one counted launch a call."""
    g = _gen(dev, form + m)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f = int4_sweep.FORMS[form]
    for k, n in ((3072, 5120), (2048, 12300)):
        w = quant.quantize4(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = _bf16(g, dev, m, k)
        before = int4_sweep.int4_sweep_matmul.forms.get(f.name, 0)
        out = int4_sweep.int4_sweep_matmul(x, w.values, w.scale, form)
        torch.cuda.synchronize()
        assert int4_sweep.int4_sweep_matmul.forms[f.name] == before + 1
        _close(out, int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale),
               rtol=RTOL_GROUPED)
        plan = int4_stream.stream_plan(m, k, n, sms, f)
        if plan == int4_stream.stream_plan(m, k, n, sms, int4_stream.DEFAULT):
            assert torch.equal(out, int4_sweep.int4_sweep_matmul(
                x, w.values, w.scale, int4_sweep.PRODUCTION))
        if form == int4_sweep.PRODUCTION and m <= quant.SPLITK_MAX_M:
            assert torch.equal(out, quant.int4_matmul(x, w.values, w.scale))


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("form", range(len(int4_sweep.SIMT_FORMS)))
def test_int4_sweep_gemv_simt(dev, form, m):
    """Row 13's first design in its kept forms at the backbone's qkv and
    the audio head: its twin within one bf16 ulp; form 0 the tiled
    instance of `gemv_int4.cu` to the bit; counted on its own."""
    g = _gen(dev, form + m)
    for k, n in ((3072, 5120), (2048, 12300)):
        w = quant.quantize4(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = _bf16(g, dev, m, k)
        name = int4_sweep.SIMT_FORMS[form].name
        before = int4_sweep.int4_sweep_matmul_simt.forms.get(name, 0)
        out = int4_sweep.int4_sweep_matmul_simt(x, w.values, w.scale, form)
        torch.cuda.synchronize()
        assert int4_sweep.int4_sweep_matmul_simt.forms[name] == before + 1
        _close(out, int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale),
               rtol=RTOL_GROUPED)
        if form == 0:
            assert torch.equal(out, quant.int4_matmul_tiled(x, w.values,
                                                            w.scale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(48, 256), (2, 24, 512), (16, 1024),
                                   (28, 768), (300, 3072)])
def test_lean_update(dev, shape, dtype):
    g = _gen(dev, 6)
    nsb = shape[-1] // 256
    args = ((torch.randn(shape, generator=g, device=dev) * 0.05).to(dtype),
            torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8),
            torch.rand(shape[:-1] + (nsb,), generator=g, device=dev) * 1e-3,
            (torch.randn(shape, generator=g, device=dev) * 0.1).to(dtype),
            torch.rand(shape[:-1], generator=g, device=dev) * 10 + 1,
            torch.rand(shape[:-2] + shape[-1:], generator=g, device=dev) * 1e-2)
    kw = dict(b1=0.9, wd=0.01, eps=1e-8)
    before = lean_update.fused_lean_update.launches
    out = lean_update.fused_lean_update(*args, 1.0 / (1 - 0.9 ** 3), 3e-4, **kw)
    torch.cuda.synchronize()
    assert lean_update.fused_lean_update.launches == before + 1
    ref = lean_update.fused_lean_update_plain(*args, 1.0 / (1 - 0.9 ** 3),
                                              3e-4, **kw)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert torch.equal(o, r), int((o != r).sum())


def test_adamw_lean_sends_card_leaves_to_the_kernel(dev):
    """Every admitted leaf on the card launches the kernel, in "auto" and
    "on"; "off" (the plain chain, for CPU leaves) raises there."""
    g = _gen(dev, 7)
    params = {"w": _bf16(g, dev, 8, 512), "gain": _bf16(g, dev, 64)}
    grads = {k: v * 0.01 for k, v in params.items()}
    for mode in ("auto", "on"):
        tx = lean_opt.adamw_lean(1e-3, fused=mode)
        before = lean_update.fused_lean_update.launches
        tx.update(grads, tx.init(params, device=dev), params)
        torch.cuda.synchronize()
        assert lean_update.fused_lean_update.launches == before + 1, mode
    tx = lean_opt.adamw_lean(1e-3, fused="off")
    with pytest.raises(ValueError):
        tx.update(grads, tx.init(params, device=dev), params)


@pytest.mark.parametrize("m,k,n", [(3966, 3072, 8192), (3966, 8192, 3072),
                                   (16384, 2048, 5632)])
def test_bf16_matmul_matches_float32_form(dev, m, k, n):
    """The training forward's bf16 product against the float32 form at
    full-width training shapes (backbone fc1 / mlp_proj at (B, S) =
    (2, 1983); the local decoder's 16,384 rows); with a residual
    `quant.matmul` takes the float32 form itself."""
    g = _gen(dev, 8)
    x, w = _bf16(g, dev, m, k), _bf16(g, dev, k, n, std=0.02)
    res = _bf16(g, dev, m, n)
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction)
    flags.allow_tf32 = False
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        out = quant.matmul(x, w)
        ref = torch.matmul(x.float(), w.float())
        with_res = quant.matmul(x, w, residual=res)
        ref_res = (ref + res.float()).to(torch.bfloat16)
        ref = ref.to(torch.bfloat16)
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved
    assert out.dtype == ref.dtype == with_res.dtype == torch.bfloat16
    rf = ref.float()
    err = (out.float() - rf).abs()
    assert bool((err <= 2.0 ** -7 * rf.abs() + 1e-3 * rf.abs().max()).all()), \
        float(err.max())
    assert torch.equal(with_res, ref_res)


def test_wrappers_raise_on_unsupported_input(dev):
    g = _gen(dev, 4)
    w = _i4(g, dev, 256, 256)
    with pytest.raises(ValueError):
        quant.int4i_matmul(torch.randn(1, 256, device=dev), w.values, w.scale)
    with pytest.raises(ValueError):
        quant.int4i_matmul(_bf16(g, dev, 1, 512), w.values, w.scale)
    x = _bf16(g, dev, 1, 256)
    with pytest.raises(ValueError):             # a grouped scale, per-channel kernel
        quant.int4_matmul(x, w.values, w.scale[None].repeat(2, 1))
    with pytest.raises(ValueError):             # 3 groups do not split K/2
        quant.int4g_matmul(x, w.values, w.scale[None].repeat(3, 1).contiguous())
    k4 = _make(g, dev, "int4", 256, 256)
    with pytest.raises(ValueError):             # a K-split down-projection
        fused_mlp.fused_swiglu(x, k4, k4, k4)
    q = _bf16(g, dev, 1, 2, 8, 32)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, 32 ** -0.5)
    q, kv = _bf16(g, dev, 1, 6, 8, 64), _bf16(g, dev, 1, 4, 8, 64)
    with pytest.raises(ValueError):             # float16: no kernel takes it
        flash_attention.flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError):             # the float32 kernel is non-causal
        flash_attention.flash_attention(q.float(), q.float(), q.float(), 0.125,
                                        causal=True)
    with pytest.raises(ValueError):             # 6 heads over 4 groups
        flash_attention.flash_attention(q, kv, kv, 0.125, causal=True)
    with pytest.raises(ValueError):             # a 100-wide chunk: no whole tiles
        int4_native.int4_native_matmul(
            x, w.values.reshape(128, 2, 128)[:, :, :100].permute(1, 0, 2)
            .contiguous(), w.scale[:200])
    with pytest.raises(ValueError):             # rows of 72 bytes: no TMA map
        int4_sweep.int4_sweep_matmul(x, w.values[:, :72].contiguous(),
                                     w.scale[:72], form=2)
    with pytest.raises(ValueError):             # rows of 64 bytes, 128-wide tiles
        int4_sweep.int4_sweep_matmul_simt(x, w.values[:, :64].contiguous(),
                                          w.scale[:64], form=1)
    w8 = quant.quantize(torch.randn((64, 40), generator=g, device=dev))
    with pytest.raises(ValueError):             # M = 2: a batch-1 kernel
        splitk_gemv.int8_splitk_gemv(_bf16(g, dev, 2, 64), w8.values, w8.scale)
    p = _bf16(g, dev, 4, 256)
    with pytest.raises(ValueError):             # g in another dtype than p
        lean_update.fused_lean_update(
            p.float(), torch.zeros(4, 256, dtype=torch.int8, device=dev),
            torch.zeros(4, 1, device=dev), p, torch.ones(4, device=dev),
            torch.ones(256, device=dev), 1.0, 1e-3, b1=0.9, wd=0.0, eps=1e-8)


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("layers,k,n", [(4, 3072, 8192), (3, 256, 512),
                                        (2, 2048, 12300)])
def test_int4_stacked_gemv(dev, layers, k, n, m):
    """Row 14 on every layer of a stack: within one bf16 ulp of its twin and
    the bits of `gemv_int4.cu`'s tiled instance on the layer's slice; an
    index past the stack gives NaN, not another layer."""
    gen = _gen(dev, layers + k + m)
    ws = [quant.quantize4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
          for _ in range(layers)]
    st = quant.QuantizedLinear4(torch.stack([w.values for w in ws]),
                                torch.stack([w.scale for w in ws]))
    x = _bf16(gen, dev, m, k)
    index = torch.arange(layers + 1, dtype=torch.int32, device=dev)
    for l in range(layers):
        out = int4_stacked.int4_stacked_matmul(x, st, index[l:l + 1])
        ref = int4_stacked.int4_stacked_matmul_plain(x, st, l)
        prod = quant.int4_matmul_tiled(x, ws[l].values, ws[l].scale)
        torch.cuda.synchronize()
        _close(out, ref, RTOL_GROUPED)
        assert torch.equal(out, prod)
    past = int4_stacked.int4_stacked_matmul(x, st, index[layers:])
    assert bool(torch.isnan(past.float()).all())


def _same_tokens(a, b):
    import numpy as np

    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tokens(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _tiny_serving(dev):
    """An int4 serving tree of `tiny(max_seq_len=1024)` on the card, a TTS
    prompt and its CFG negative."""
    import numpy as np

    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.engine import tasks
    from uniaudio2_tpu_torch.models import unified

    cfg = UnifiedModelConfig.tiny(max_seq_len=1024)
    p = unified.init_params(cfg, _gen(dev, 5), dtype=torch.bfloat16, device=dev)
    p = unified.prepare_serving_params(quant.quantize_unified_params(
        p, int4_modules=("backbone", "decoder", "understanding_expert",
                         "generation_expert", "audio_head", "projection_w")))
    ts = cfg.tokens
    return (cfg, p,
            tasks.prepare_tts(np.array([1, 5, 6, 7]), np.array([3, 10, 2]), ts),
            tasks.prepare_tts_cfg_negative(np.array([1, 5, 6, 7]),
                                           np.array([3, 10, 2]), ts))


def test_frame_graph_tokens_equal_eager_on_tiny(dev):
    """`tiny()` on the card: the captured frame graphs give the eager
    loop's greedy tokens (TTS, ASR, a CFG pair, 4 ragged rows, the int8 KV
    cache with block-128 levels, inline and deferred) and the eager loop's
    per-row sampled tokens; a replayed request counts the eager loop's
    launches."""
    import numpy as np

    from uniaudio2_tpu_torch.engine import decode, tasks
    from uniaudio2_tpu_torch.ops import _cuda

    cfg, p, (g, m), (ng, nm) = _tiny_serving(dev)
    ts = cfg.tokens
    rng = np.random.default_rng(0)
    items = [tasks.prepare_asr(np.array([4, 8, 9]),
                               rng.integers(0, 30, (3 + i, 8)),
                               rng.integers(0, 60, (5 + i, 8)), ts)
             for i in range(4)]

    def launches(eng):
        before = _cuda.counts()
        eng.generate_audio(g, m, topk=1)
        return eng.last_steps, eng.last_frames_run, _cuda.counts_since(before)

    for kw, frames in (({}, 24), ({"kv_write": "deferred"}, 300)):
        outs, counted = [], []
        for graph in (False, True):
            eng = decode.DecodeEngine(p, cfg, max_frames=frames, buckets=(64,),
                                      graph=graph, **kw)
            outs.append([
                eng.generate_audio(g, m, topk=1),
                eng.generate_text(*items[0], topk=1),
                eng.generate_audio(g, m, topk=1, use_cfg=True, cfg_scale=1.5,
                                   neg_grid=ng, neg_mask=nm),
                eng.generate_text_batch(items, topk=1),
                eng.generate_text_batch(items, topk=5, seeds=[1, 2, 3, 4]),
            ])
            counted.append(launches(eng))
            if graph:
                assert eng.frame_graphs and eng.capture_seconds > 0
        _same_tokens(*outs)
        (n_e, run_e, eager), (n_g, run_g, replayed) = counted
        assert n_e == n_g and run_e == n_e
        if run_g == n_g:            # no replay past the last EOS
            assert replayed == eager


def test_frame_graph_shared_stream_and_new_levels_on_tiny(dev):
    """`tiny()` on the card at the engine's policies with 200 frames (512
    slots: int8 KV, block-128 levels): TTS sampled from the shared
    generator (the default topk 200, seeded) on a bucket-64 prompt that
    runs to max_frames, then a bucket-256 prompt through the same program,
    which captures two new levels, then the CFG pair sampled, and the same
    greedily: the tokens of a fresh eager engine each."""
    import numpy as np

    from uniaudio2_tpu_torch.engine import decode, tasks

    cfg, p, (g, m), (ng, nm) = _tiny_serving(dev)
    lg, lm = tasks.prepare_tts(np.array([1, 5, 6, 7]),
                               np.arange(200) % 50 + 3, cfg.tokens)
    assert decode.pick_bucket(lg.shape[0]) == 256
    for sampling in (dict(seed=5), dict(topk=1)):
        eng = decode.DecodeEngine(p, cfg, max_frames=200)
        requests = [(g, m, {}), (lg, lm, {}),
                    (g, m, dict(use_cfg=True, cfg_scale=1.5, neg_grid=ng,
                                neg_mask=nm))]
        for i, (grid, mask, kw) in enumerate(requests):
            got = eng.generate_audio(grid, mask, **sampling, **kw)
            if i == 0:
                assert eng.last_steps == 200
            assert eng.last_policy["attn_block"] == 128
            assert eng.last_policy["cache_len"] == 512
            fresh = decode.DecodeEngine(p, cfg, max_frames=200, graph=False)
            _same_tokens(got, fresh.generate_audio(grid, mask, **sampling,
                                                   **kw))
        (fg, _) = eng.frame_graphs.values()
        assert sorted(fg.graphs) == [128, 256, 384, 512]


TC_FORMS = {"int4c": (quant.int4c_matmul, quant.int4c_matmul_tiled),
            "int4cg": (quant.int4cg_matmul, quant.int4cg_matmul_tiled)}


def _c4_odd(gen, dev, form, k, n, group):
    """A column-packed container of odd width ``n`` (the quantizers take
    even N only; the kernels any): random bytes in a storage 64 bytes wider
    than ceil(N/2), random positive scales ((K/group, N) when grouped)."""
    ldw = -(-(n - n // 2) // 64) * 64 + 64
    values = torch.randint(-128, 128, (k, ldw), generator=gen, device=dev,
                           dtype=torch.int8)
    shape = (k // group, n) if form == "int4cg" else (n,)
    scale = 0.002 + 0.002 * torch.rand(shape, generator=gen, device=dev)
    cls = quant.QuantizedLinearC4G if form == "int4cg" else quant.QuantizedLinearC4
    return cls(values, scale)


def _tc_call(dev, form, w, x, **kw):
    """One call of the column-packed wrapper: exactly one launch, on the
    kernel `tc_plan` names (the tile kernel above 16 rows: the tiled
    yardstick's count does not move), the same bits twice."""
    fn, tiled = TC_FORMS[form]
    m, k = x.shape
    n = w.scale.shape[-1]
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    plan = quant.tc_plan(m, k, n, g, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.splits > 0
    before = (fn.launches, tiled.launches)
    out = fn(x, w.values, w.scale, **kw)
    again = fn(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, tiled.launches) == (before[0] + 2, before[1])
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("m", [17, 63, 128, 129, 255, 510])
@pytest.mark.parametrize("k,n", [(8192, 3072), (8192, 2048)])
@pytest.mark.parametrize("form", list(TC_FORMS))
def test_int4c_tile_gemv(dev, form, k, n, m):
    """Rows 7 and 8 above 16 rows on the tensor-core tile kernel, at the MLP
    down-projections (G = 64 grouped): within the twin's bound (one bf16
    ulp grouped), one launch of the tile kernel a call."""
    g = _gen(dev, 31 + m)
    w = _make(g, dev, form, k, n, group=k // 64)
    x = _bf16(g, dev, m, k)
    out = _tc_call(dev, form, w, x)
    _close(out, quant.matmul_plain(x, w),
           RTOL_GROUPED if form == "int4cg" else RTOL)


@pytest.mark.parametrize("m", [40, 130, 255])
@pytest.mark.parametrize("n", [600, 601])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
@pytest.mark.parametrize("form", list(TC_FORMS))
def test_int4c_tile_gemv_folds(dev, form, norm, res, out_dtype, n, m):
    """The folds the column-packed C entry points admit, at an even N
    (quantized, storage padded to 384 bytes) and an odd N (ldw 384 >
    ceil(N/2) = 301), K = 512, groups of 64 rows: f32 output on the tile
    kernel, one launch a call; a norm prologue or a residual, which these
    entry points do not send to the tile kernel, on the tiled instance: the entry point,
    given the tile kernel's plan, gives the tiled yardstick's bits. Within
    the twin's bound."""
    g = _gen(dev, 41 + m + n)
    k = 512
    w = (_make(g, dev, form, k, n, group=64) if n % 2 == 0
         else _c4_odd(g, dev, form, k, n, 64))
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    if norm or res:
        fn, tiled = TC_FORMS[form]
        before = (fn.launches, tiled.launches)
        out = tiled(x, w.values, w.scale, **kw)
        assert (fn.launches, tiled.launches) == (before[0], before[1] + 1)
        gs = w.scale.shape[0] if w.scale.ndim == 2 else 0
        plan = quant.tc_plan(m, k, n, gs, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        assert plan.splits > 0
        entry = torch.empty_like(out)
        name = "ua2_gemv_int4cg" if form == "int4cg" else "ua2_gemv_int4c"
        nw, eps = kw["pre_norm"] or (None, 0.0)
        _cuda.check(getattr(_cuda.lib(), name)(
            _cuda.ptr(x), _cuda.ptr(w.values), _cuda.ptr(w.scale),
            _cuda.ptr(nw), _cuda.ptr(kw["residual"]), _cuda.ptr(entry), m, k,
            n, w.values.shape[1], gs, eps, int(out.dtype == torch.float32),
            plan.splits, plan.span, _cuda.stream_of(x)), name)
        torch.cuda.synchronize()
        assert torch.equal(entry, out)
    else:
        out = _tc_call(dev, form, w, x, out_dtype=out_dtype)
    grouped_plain = form == "int4cg" and not res
    _close(out, quant.matmul_plain(x, w, **kw),
           RTOL_GROUPED if grouped_plain else RTOL)


@pytest.mark.parametrize("m", [1, 63, 255])
@pytest.mark.parametrize("form", list(TC_FORMS))
def test_int4c_tiled_yardstick(dev, form, m):
    """The tiled instances at any M, counted on their own (the wrapper's
    count does not move): within the twin's bound; the wrapper at 16 rows
    or fewer launches the same kernel and gives its bits."""
    g = _gen(dev, 51 + m)
    k, n = 8192, 3072
    w = _make(g, dev, form, k, n, group=128)
    x = _bf16(g, dev, m, k)
    fn, tiled = TC_FORMS[form]
    before = (fn.launches, tiled.launches)
    out = tiled(x, w.values, w.scale)
    torch.cuda.synchronize()
    assert (fn.launches, tiled.launches) == (before[0], before[1] + 1)
    _close(out, quant.matmul_plain(x, w),
           RTOL_GROUPED if form == "int4cg" else RTOL)
    if m <= quant.SPLITK_MAX_M:
        assert torch.equal(fn(x, w.values, w.scale), out)


def _codec_on_card_and_cpu(dev, dit_cfg):
    """One decode of the tiny codec with DiT ``dit_cfg`` from the default
    float32 tree of `init_decode_params`, on the card and on the CPU, with
    the same numpy noise; TF32 off for the card's convolutions and
    products (restored after). Returns both waveforms and the card run's
    DiT attention counts (flash kernel, plain path)."""
    import dataclasses

    import numpy as np

    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.codec.decoder import (
        CodecConfig, CodecDecoder, init_decode_params,
    )

    cfg = dataclasses.replace(CodecConfig.tiny(), dit=dit_cfg)
    params = init_decode_params(torch.Generator().manual_seed(3), cfg,
                                device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v, device) for v in tree)
        return tree.to(device) if torch.is_tensor(tree) else tree

    codes = np.random.default_rng(4).integers(0, cfg.rec_codebook_size, (8, 40))

    def noise(i, shape):
        return np.random.default_rng(10 + i).standard_normal(shape, np.float32)

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        counts = (flash_attention.flash_attention.launches,
                  dit._attention.plain_launches)
        card = CodecDecoder(to(params, dev), cfg).decode(
            codes, num_steps=4, noise_fn=noise)
        counts = (flash_attention.flash_attention.launches - counts[0],
                  dit._attention.plain_launches - counts[1])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    cpu = CodecDecoder(params, cfg).decode(codes, num_steps=4, noise_fn=noise)
    return card, cpu, counts


@pytest.mark.parametrize("head_dim", [64, 16])
def test_codec_float32_tree_on_the_card(dev, head_dim):
    """F6: the codec's default float32 tree decodes on the card within
    1e-5 x max|cpu| of the same decode on the CPU; at head dim 64 (a DiT
    of 2 x 2 x 64) its DiT attention runs the float32 flash kernel, at 16
    (`DiTConfig.tiny()`) the einsum path."""
    import dataclasses

    import numpy as np

    from uniaudio2_tpu_torch.codec.dit import DiTConfig

    dit_cfg = DiTConfig.tiny()
    if head_dim != dit_cfg.head_dim:
        dit_cfg = dataclasses.replace(dit_cfg, head_dim=head_dim)
    dit_cfg = dataclasses.replace(dit_cfg, in_channels=32)   # 8 + 8 + 16
    f32 = flash_attention.flash_attention.forms.get("f32", 0)
    card, cpu, (kernel, plain) = _codec_on_card_and_cpu(dev, dit_cfg)
    f32 = flash_attention.flash_attention.forms.get("f32", 0) - f32
    assert card.shape == cpu.shape and np.isfinite(card).all()
    if head_dim == 64:
        assert kernel == f32 > 0 and plain == 0
    else:
        assert kernel == 0 and plain > 0
    err = np.abs(card - cpu).max()
    assert err <= 1e-5 * np.abs(cpu).max(), err


def test_codec_bf16_dit_still_takes_the_kernel(dev):
    """bf16 at head dim 64 still launches the flash kernel, once a layer
    and solver step, and never the plain path."""
    import dataclasses

    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.codec.dit import DiTConfig

    cfg = dataclasses.replace(DiTConfig.tiny(), head_dim=64, in_channels=32)
    params = dit.init_params(_gen(dev, 61), cfg, dtype=torch.bfloat16,
                             device=dev)
    x = _bf16(_gen(dev, 62), dev, 2, 40, cfg.in_channels)
    t = torch.full((2,), 0.5, device=dev)
    before = (flash_attention.flash_attention.launches,
              dit._attention.plain_launches)
    out = dit.forward(params, cfg, x, t)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention.launches,
            dit._attention.plain_launches) == (before[0] + cfg.num_layers,
                                               before[1])
    assert bool(torch.isfinite(out.float()).all())


ROW_TC_FORMS = {"int4i": (quant.int4i_matmul, quant.int4i_matmul_tiled),
                "int4ig": (quant.int4i_matmul, quant.int4i_matmul_tiled),
                "int4": (quant.int4_matmul, quant.int4_matmul_tiled),
                "int4g": (quant.int4g_matmul, quant.int4g_matmul_tiled)}
# the prefill's calls of rows 1 and 6: (K, N, norm, residual), the QKV
# projection with its norm, attn_proj with its residual, gate / up, the
# interleaved down-projection (row 6's is row 8), and a ragged narrow one
ROW_TC_SHAPES = {"qkv +norm": (3072, 5120, True, False),
                 "attn_proj +res": (3072, 3072, False, True),
                 "gate/up": (3072, 8192, False, False),
                 "mlp_proj": (8192, 3072, False, False),
                 "ragged +norm +res": (512, 601, True, True)}


def _row_tc_call(dev, form, w, x, **kw):
    """One call of a row-packed wrapper above 16 rows: one launch counted
    on the wrapper and one on the tile kernel's counter under the form,
    none on the tiled yardstick, the same bits twice."""
    fn, tiled = ROW_TC_FORMS[form]
    m, k = x.shape
    n = w.scale.shape[-1]
    g = w.scale.shape[0] if w.scale.ndim == 2 else 0
    layout = quant.LAYOUTS[type(w)]
    plan = quant.tc_plan(m, k, n, g, torch.cuda.get_device_properties(
        dev).multi_processor_count, layout)
    assert plan.splits > 0
    before = (fn.launches, tiled.launches, quant.gemv_tc.forms.get(form, 0))
    out = fn(x, w.values, w.scale, **kw)
    again = fn(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, tiled.launches, quant.gemv_tc.forms.get(form, 0)) == (
        before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("m", [17, 63, 255, 510])
@pytest.mark.parametrize("form,shape", [
    (form, shape) for form in ROW_TC_FORMS for shape in ROW_TC_SHAPES
    if not (form in ("int4", "int4g") and shape == "mlp_proj")])
def test_row_tile_gemv(dev, form, shape, m):
    """Rows 1 (per channel and grouped), 5 and 6 above 16 rows on the tile
    kernel, with the folds their served callers pass (the QKV norm, the
    attn_proj residual) and all of them on a ragged (512, 601): within the
    twin's bound (one bf16 ulp grouped without a residual); at M = 63 also
    with f32 output. The K-split trees' down-projection is row 7's or 8's,
    so rows 5 and 6 skip mlp_proj."""
    g = _gen(dev, 61 + m)
    k, n, norm, res = ROW_TC_SHAPES[shape]
    w = _make(g, dev, form, k, n, group=64 if k == 512 else 128)
    x = _bf16(g, dev, m, k)
    kw = dict(pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    for out_dtype in (None, torch.float32) if m == 63 else (None,):
        out = _row_tc_call(dev, form, w, x, out_dtype=out_dtype, **kw)
        grouped_plain = form != "int4i" and not res
        _close(out, quant.matmul_plain(x, w, out_dtype=out_dtype, **kw),
               RTOL_GROUPED if grouped_plain else RTOL)


def test_row_tile_gemv_rejects_swapped_k_halves(dev):
    """A planted fault the check above must reject: row 6's weight with its
    K-split halves swapped (each byte's nibbles exchanged, so row r takes
    row K/2 + r's level), through the tile kernel with the QKV norm, lands
    far outside one bf16 ulp of the sound twin."""
    g = _gen(dev, 71)
    k, n, m = 3072, 5120, 255
    w = _make(g, dev, "int4g", k, n)
    x = _bf16(g, dev, m, k)
    kw = dict(pre_norm=(_bf16(g, dev, k), 1e-5))
    v = w.values.to(torch.int32) & 0xFF
    swapped = ((((v << 4) | (v >> 4)) & 0xFF).to(torch.uint8).view(torch.int8)
               .contiguous())
    ref = quant.matmul_plain(x, w, **kw)
    _close(_row_tc_call(dev, "int4g", w, x, **kw), ref, RTOL_GROUPED)
    bad = _row_tc_call(dev, "int4g", type(w)(swapped, w.scale), x, **kw)
    with pytest.raises(AssertionError):
        _close(bad, ref, RTOL_GROUPED)


# The fused SwiGLU's served forms (gate / up + down) and widths (K, I)
SWIGLU_SERVED = [("int4i", "int4i"), ("int4ig", "int4ig"), ("int4", "int4c"),
                 ("int4g", "int4cg"), ("int8", "int8")]
SWIGLU_WIDTHS = {"backbone": (3072, 8192), "decoder": (2048, 8192)}


def _swiglu_weights(dev, up, down, k, i, seed):
    g = _gen(dev, seed)
    return g, (_make(g, dev, up, k, i), _make(g, dev, up, k, i),
               _make(g, dev, down, i, k))


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 63, 126, 128])
@pytest.mark.parametrize("width", list(SWIGLU_WIDTHS))
@pytest.mark.parametrize("up,down", SWIGLU_SERVED)
def test_fused_swiglu_served_forms(dev, up, down, width, m):
    """Every served form at both widths and every M the frame loop and the
    bucket-64 prefill give it, plain and with the norm and the residual:
    within 2e-2 x max|twin|, one `fused_swiglu` count a call under its
    form, none on the GEMV wrappers or the tiled yardstick, the same bits
    twice; above 16 rows one count of each tile pass a call."""
    k, i = SWIGLU_WIDTHS[width]
    g, (w1, w2, w3) = _swiglu_weights(dev, up, down, k, i, 81 + m)
    x = _bf16(g, dev, m, k)
    form = f"{up}+{down}"
    for kw in ({}, dict(norm_w=_bf16(g, dev, k),
                        residual=_bf16(g, dev, m, k, std=0.1))):
        assert fused_mlp.can_fuse(w1, w2, w3, x)
        watched = (fused_mlp.fused_swiglu, fused_mlp.fused_swiglu_tiled,
                   quant.int4i_matmul, quant.int4_matmul, quant.int4g_matmul,
                   quant.int4c_matmul, quant.int4cg_matmul, quant.int8_matmul)
        before = [fn.launches for fn in watched]
        f0 = fused_mlp.fused_swiglu.forms.get(form, 0)
        tile0 = (fused_mlp.swiglu_tc.launches, quant.gemv_tc.forms.get(down, 0))
        out = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
        again = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
        torch.cuda.synchronize()
        assert [fn.launches for fn in watched] == [before[0] + 2] + before[1:]
        assert fused_mlp.fused_swiglu.forms[form] == f0 + 2
        tiles = 2 if m > quant.SPLITK_MAX_M else 0
        assert (fused_mlp.swiglu_tc.launches, quant.gemv_tc.forms.get(down, 0)) \
            == (tile0[0] + tiles, tile0[1] + tiles)
        assert torch.equal(out, again)
        _close(out, fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw))


@pytest.mark.parametrize("m", [1, 63, 126])
@pytest.mark.parametrize("up,down", SWIGLU_SERVED)
def test_fused_swiglu_tiled_yardstick(dev, up, down, m):
    """The first design's tiled passes (`fused_swiglu_tiled`, the yardstick)
    at decode and prefill M: within 2e-2 x max|twin|, counted on their
    own (not on `fused_swiglu` nor on the tile passes' counters)."""
    k, i = SWIGLU_WIDTHS["backbone"]
    g, (w1, w2, w3) = _swiglu_weights(dev, up, down, k, i, 91 + m)
    x = _bf16(g, dev, m, k)
    kw = dict(norm_w=_bf16(g, dev, k), residual=_bf16(g, dev, m, k, std=0.1))
    counted = (fused_mlp.fused_swiglu, fused_mlp.fused_swiglu_tiled,
               fused_mlp.swiglu_tc, quant.gemv_tc)
    before = [fn.launches for fn in counted]
    out = fused_mlp.fused_swiglu_tiled(x, w1, w2, w3, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == \
        [before[0], before[1] + 1] + before[2:]
    _close(out, fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw))


def _swiglu_pair(dev, pair, k, i, seed):
    """A K-split tree (gate / up K-split, down column-packed, per channel
    or grouped) and its interleaved copy: the same levels and scales."""
    g = _gen(dev, seed)
    grouped = pair == "grouped"
    up, down = ("int4g", "int4cg") if grouped else ("int4", "int4c")
    ksplit = (_make(g, dev, up, k, i), _make(g, dev, up, k, i),
              _make(g, dev, down, i, k))
    return g, ksplit, tuple(quant.to_interleaved(w) for w in ksplit)


@pytest.mark.parametrize("m", [17, 63, 126, 128])
@pytest.mark.parametrize("width", list(SWIGLU_WIDTHS))
@pytest.mark.parametrize("pair", ["per channel", "grouped"])
def test_fused_swiglu_tile_passes_byte_orders(dev, pair, width, m):
    """Above 16 rows `int4+int4c` gives `int4i+int4i` its bits and
    `int4g+int4cg` gives `int4ig+int4ig` its bits on the same levels, plain
    and with the norm and the residual: pass 1's h (the K-split layout read
    in x's k order, the interleaved one's plan) and pass 2's output (the
    column-packed and interleaved tile GEMVs, one plan)."""
    k, i = SWIGLU_WIDTHS[width]
    g, ksplit, inter = _swiglu_pair(dev, pair, k, i, 101 + m)
    x = _bf16(g, dev, m, k)
    for kw in ({}, dict(norm_w=_bf16(g, dev, k),
                        residual=_bf16(g, dev, m, k, std=0.1))):
        outs = []
        for w1, w2, w3 in (ksplit, inter):
            x2, res2, m2, k2, i2, n2, g12, g3 = fused_mlp._operands(
                "fused_swiglu", x, w1, w2, w3, kw.get("norm_w"),
                kw.get("residual"))
            plan = fused_mlp.swiglu_plan(
                m2, k2, i2, n2, g12, quant.LAYOUTS[type(w1)], g3,
                quant.LAYOUTS[type(w3)], quant._sm_count(dev))
            assert plan.kind == "tile"
            outs.append(fused_mlp._tile_passes(
                x2, w1, w2, w3, kw.get("norm_w"), 1e-5, res2, plan))
            assert torch.equal(outs[-1][0], fused_mlp.fused_swiglu(
                x, w1, w2, w3, **kw))
        torch.cuda.synchronize()
        (out_k, h_k), (out_i, h_i) = outs
        assert torch.equal(h_k, h_i), (h_k.float() - h_i.float()).abs().max()
        assert torch.equal(out_k, out_i), \
            (out_k.float() - out_i.float()).abs().max()
        _close(out_k, fused_mlp.fused_swiglu_plain(x, *ksplit, **kw))


@pytest.mark.parametrize("up,down", SWIGLU_SERVED)
def test_fused_swiglu_is_two_graph_nodes(dev, up, down, tmp_path):
    """A decode call captured in a CUDA graph is two kernel nodes, both the
    split-K kernel's, and its replay gives the eager call's bits."""
    k, i = SWIGLU_WIDTHS["backbone"]
    g, (w1, w2, w3) = _swiglu_weights(dev, up, down, k, i, 99)
    x = _bf16(g, dev, 1, k)
    kw = dict(norm_w=_bf16(g, dev, k), residual=_bf16(g, dev, 1, k, std=0.1))
    ref = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    dot = tmp_path / "graph.dot"
    graph.debug_dump(str(dot))
    kernels = [line for line in dot.read_text().splitlines()
               if "kernel" in line and ("gemv" in line or "swiglu" in line)]
    assert len(kernels) == 2 and all("gemv_splitk_kernel" in line
                                     for line in kernels), kernels


def test_fused_swiglu_refuses_small_w3_groups(dev):
    """A column-packed W3 with groups of 8 rows, which the split-K pass 2
    does not take (a step of 16 rows must lie in one group): `can_fuse`
    refuses it, so the model runs the unfused GEMVs, and a direct call
    raises: no fallback to the tiled passes."""
    g = _gen(dev, 98)
    w1, w2 = _make(g, dev, "int4", 512, 1024), _make(g, dev, "int4", 512, 1024)
    w3 = _make(g, dev, "int4cg", 1024, 512, group=8)
    x = _bf16(g, dev, 1, 512)
    assert not fused_mlp.can_fuse(w1, w2, w3, x)
    with pytest.raises(ValueError):
        fused_mlp.fused_swiglu(x, w1, w2, w3)
