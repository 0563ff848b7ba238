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
averages i + 1 values and is ~sqrt(1 / i) the size of row 0.
The two int4 probe kernels (rows 11 and 13: the conversion-free unpack
and the twelve tile forms of the K-split GEMV) add exact f32 products in
another order than their twins and round once: one bf16 ulp
(RTOL_GROUPED). With the production template's tiles they sum in its
order, so the native kernel gives `gemv_int4i.cu`'s bits and sweep form 0
`gemv_int4.cu`'s. Row 14's stacked-layer kernel, with the layer index read
on the device, is held to its twin within one bf16 ulp and to
`gemv_int4.cu`'s bits on every layer's slice.
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
    flash_attention, fused_mlp, int4_native, int4_stacked, int4_sweep,
    lean_update, qkv_step, quant, splitk_gemv,
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


@pytest.mark.parametrize("m", [1, 2, 63, 130])
@pytest.mark.parametrize("norm,res,out_dtype", FOLDS)
def test_int8_matmul(dev, m, norm, res, out_dtype):
    g = _gen(dev, 1)
    k, n = 384, 1000
    w = quant.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    x = _bf16(g, dev, m, k)
    kw = dict(out_dtype=out_dtype,
              pre_norm=(_bf16(g, dev, k), 1e-5) if norm else None,
              residual=_bf16(g, dev, m, n, std=0.1) if res else None)
    out = quant.int8_matmul(x, w.values, w.scale, **kw)
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    _close_rows(out, flash_attention.attention_plain(q, k, v, hd ** -0.5))


@pytest.mark.parametrize("b,h,g_,t,hd", [(1, 24, 8, 2048, 128), (1, 24, 8, 1000, 128),
                                          (1, 4, 2, 130, 128), (2, 6, 3, 77, 64),
                                          (1, 8, 8, 64, 64), (1, 2, 1, 1, 128)])
def test_flash_attention_causal_gqa(dev, b, h, g_, t, hd):
    """The causal form with K/V heads mapped in place (h -> h / (H / G)),
    T not a multiple of the 64-key tile included."""
    g = _gen(dev, 6)
    q = _bf16(g, dev, b, h, t, hd)
    k, v = (_bf16(g, dev, b, g_, t, hd) for _ in range(2))
    before = dict(flash_attention.flash_attention.forms)
    out = flash_attention.flash_attention(q, k, v, hd ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.forms["causal"] == \
        before.get("causal", 0) + 1
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


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("k,n", [(256, 512), (512, 1024), (3072, 8192),
                                 (2048, 12300)])
def test_int4_native_gemv(dev, k, n, m):
    """Row 11's kernel: its twin within one bf16 ulp, the production
    row-interleaved kernel to the bit, row-major and chunk-major alike."""
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
    assert torch.equal(out, quant.int4i_matmul(x, w.values, w.scale))


def test_int4_sweep_form_table(dev):
    int4_sweep.check_forms()


@pytest.mark.parametrize("m", [1, 8, 16, 21])
@pytest.mark.parametrize("form", range(len(int4_sweep.FORMS)))
def test_int4_sweep_gemv(dev, form, m):
    """Row 13's kernel in every form at the backbone's qkv and the audio
    head (N = 12300, a partial last tile): its twin within one bf16 ulp;
    form 0 `gemv_int4.cu` to the bit."""
    g = _gen(dev, form + m)
    for k, n in ((3072, 5120), (2048, 12300)):
        w = quant.quantize4(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = _bf16(g, dev, m, k)
        name = int4_sweep.FORMS[form].name
        before = int4_sweep.int4_sweep_matmul.forms.get(name, 0)
        out = int4_sweep.int4_sweep_matmul(x, w.values, w.scale, form)
        torch.cuda.synchronize()
        assert int4_sweep.int4_sweep_matmul.forms[name] == before + 1
        _close(out, int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale),
               rtol=RTOL_GROUPED)
        if form == int4_sweep.PRODUCTION:
            assert torch.equal(out, quant.int4_matmul(x, w.values, w.scale))


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
    with pytest.raises(ValueError):             # 6 heads over 4 groups
        flash_attention.flash_attention(q, kv, kv, 0.125, causal=True)
    with pytest.raises(ValueError):             # a 100-wide chunk: no whole tiles
        int4_native.int4_native_matmul(
            x, w.values.reshape(128, 2, 128)[:, :, :100].permute(1, 0, 2)
            .contiguous(), w.scale[:200])
    with pytest.raises(ValueError):             # rows of 64 bytes, 128-wide tiles
        int4_sweep.int4_sweep_matmul(x, w.values[:, :64].contiguous(),
                                     w.scale[:64], form=2)
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
    the bits of `gemv_int4.cu` on the layer's slice; an index past the
    stack gives NaN, not another layer."""
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
        prod = quant.int4_matmul(x, ws[l].values, ws[l].scale)
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
