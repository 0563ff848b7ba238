"""The float32 flash attention kernel's arithmetic (row 10's float32 form,
`csrc/flash_attn_f32.cu`, ``flash_f32_tc_kernel``), emulated on the CPU.

The kernel runs both products on the tensor cores as three TF32 products:
each operand x is split into hi = tf32(x), rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``: 10 bits of mantissa), and
lo = tf32(x - hi); a product is lo.hi + hi.lo + hi.hi, summed from zero for
each 8-deep step and added to the running f32 sum. The emulation rounds to
TF32 by bit masking and follows the kernel's order: 64-key tiles, scores
x scale x log2(e), the online softmax with exp2, P split from the f32
probabilities, O / l at the end. It is held within 1e-5 x each row's
max|ref| (the card's gate, `chip_smoke.RTOL_F32`) of JAX's
`_flash_attention` (uniaudio2_tpu/codec/dit.py:174-193, JAX's Pallas
`flash_attention` in interpret mode, float32) and of the port's twin
(`flash_attention.attention_plain`); a split into bf16 hi and lo parts
(3xBF16, ~16 bits an operand) is shown to be too coarse for that gate.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.codec import dit as jdit

from uniaudio2_tpu_torch.ops import flash_attention as fa

RTOL_F32 = 1e-5
BK = 64                                    # keys a tile, as the kernel


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does (f32 bits, the low 13
    zero; |x| far below the overflow)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mm3(a, b, split):
    """a (.., M, D) @ b (.., D, N): for each 8-deep step, lo.hi + hi.lo +
    hi.hi from zero, added to the f32 sum."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for d in range(0, a.shape[-1], 8):
        a8, b8 = a[..., d:d + 8], b[..., d:d + 8, :]
        ah, bh = split(a8), split(b8)
        al, bl = split(a8 - ah), split(b8 - bh)
        out = out + (al @ bh + ah @ bl + ah @ bh)
    return out


def _emulate(q, k, v, scale, split=_tf32):
    """The kernel's flash attention of (B, H, T, hd) float32 q, k, v."""
    t = q.shape[2]
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    for key0 in range(0, t, BK):
        kt, vt = k[:, :, key0:key0 + BK], v[:, :, key0:key0 + BK]
        s = _mm3(q, kt.transpose(-1, -2), split) * scale_log2
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(p, vt, split)
        m = mn
    return acc / l


def _rows_err(got, ref):
    """The worst row's max|got - ref| over its own max|ref|."""
    return (np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max()


@pytest.mark.parametrize("t,hd", [(130, 64), (200, 128)])
def test_3xtf32_emulation_matches_jax_flash_and_the_twin(t, hd):
    b, h = 1, 2
    rng = np.random.default_rng(t + hd)
    q, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32)
               for _ in range(3))
    scale = hd ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    emu = _emulate(tq, tk, tv, scale).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdit._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd), np.float32)
    twin = fa.attention_plain(tq, tk, tv, scale).numpy()
    assert _rows_err(emu, ref) <= RTOL_F32
    assert _rows_err(emu, twin) <= RTOL_F32
    # bf16 hi and lo parts keep ~16 bits an operand: well over the gate
    assert _rows_err(_emulate(tq, tk, tv, scale, split=_bf16).numpy(),
                     twin) > RTOL_F32


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """`_tf32` against cvt.rna.tf32.f32's definition: to 10 bits of
    mantissa, a tie (the dropped 13 bits exactly half) away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -23,
                      1.0 + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    r = _tf32(y)
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
