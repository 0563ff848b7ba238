"""The twins of the two probe kernels against the JAX Pallas functions they
replace, run in interpret mode on the CPU (as `tests/test_qkv_step.py` runs
the package's own kernels), and the probes' CPU-side pieces.

* Row 12, `vpu_gemv` (scripts/profile_gemv.py, loaded by path): the split-K
  GEMV's twin within one bf16 ulp of each output (2^-7 x |jax|): both add
  exact f32 products in f32, in another order, and round once.
* Row 15, `bb_flash`'s kernel, JAX's bundled Pallas `flash_attention` with
  ``causal=True`` over K/V repeated from G groups: the causal GQA twin (and
  the flash wrapper, which takes it on CPU tensors) within 2e-2 x max|jax|
  in bf16 (the two round the probabilities to bf16 at other points), and
  the same against JAX's `causal_attention`, the production path. Each
  query row is held to its own max: a causal row i averages i + 1 values
  and is ~sqrt(1 / i) the size of row 0, a copy of v[0].
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as jax_flash,
)

from uniaudio2_tpu.ops import quant as jquant
from uniaudio2_tpu.ops.attention import causal_attention as jax_causal

from uniaudio2_tpu_torch.ops import attention, flash_attention, quant, splitk_gemv
from uniaudio2_tpu_torch.probes import profile_attention, profile_gemv

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7
RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_gemv():
    return _script("profile_gemv")


@pytest.mark.parametrize("k,n,block_n", [(256, 700, 512), (128, 1300, 2048),
                                         (512, 384, 512)])
def test_splitk_twin_matches_vpu_gemv(jax_gemv, k, n, block_n):
    """N = 700 and 1300 are not multiples of the block (the trim); 1300
    pads to 1536 columns, so the JAX wrapper halves its 2048 block."""
    rng = np.random.default_rng(k + n)
    w = jquant.quantize(jnp.asarray(rng.standard_normal((k, n)) * 0.02,
                                    jnp.bfloat16))
    x = jnp.asarray(rng.standard_normal((1, k)), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_gemv.vpu_gemv(x, w, block_n=block_n), np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(w.values))
    ts = torch.from_numpy(np.asarray(w.scale))
    out = splitk_gemv.int8_splitk_gemv(tx, tv, ts)
    assert out.shape == (1, n) and out.dtype == torch.bfloat16
    assert np.all(np.abs(out.float().numpy() - ref) <= ULP * np.abs(ref))


@pytest.mark.parametrize("k,n", list(profile_gemv.SHAPES + profile_gemv.MORE_SHAPES)
                         + [(256, 700), (64, 64), (96, 40)])
def test_splitk_plan_fills_the_card(k, n):
    """Chunks of whole 32-row lanes cover K exactly once, and at the probe's
    shapes the grid holds at least four blocks for each of the 132 SMs."""
    splits, chunk = splitk_gemv.plan(k, n)
    assert chunk % 32 == 0 and splits * chunk >= k > (splits - 1) * chunk
    if (k, n) in profile_gemv.SHAPES + profile_gemv.MORE_SHAPES:
        assert splits * -(-n // 128) >= 4 * 132


def _qkv(shape_q, groups, seed):
    rng = np.random.default_rng(seed)
    b, h, t, hd = shape_q
    q = rng.standard_normal((b, h, t, hd)).astype(np.float32)
    k = rng.standard_normal((b, groups, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, groups, t, hd)).astype(np.float32)
    return q, k, v


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _rows_close(got, ref):
    """Every row (last axis) within RTOL x its own max|ref|."""
    worst = (np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max()
    assert worst <= RTOL, worst


def test_causal_gqa_twin_matches_pallas_flash_and_einsum():
    b, h, g, t, hd = 1, 4, 2, 256, 128
    q, k, v = _qkv((b, h, t, hd), g, 0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    scale = hd ** -0.5
    with pltpu.force_tpu_interpret_mode():      # bb_flash's call
        ref = jax_flash(jq, jnp.repeat(jk, h // g, axis=1),
                        jnp.repeat(jv, h // g, axis=1), causal=True,
                        sm_scale=scale)
    ref = np.asarray(ref, np.float32)
    tq, tk, tv = (_bf16(a) for a in (q, k, v))
    twin = flash_attention.attention_plain(tq, tk, tv, scale, causal=True)
    wrapper = flash_attention.flash_attention(tq, tk, tv, scale, causal=True)
    assert torch.equal(twin, wrapper) and twin.shape == (b, h, t, hd)
    for got in (twin.float().numpy(),
                # the port's production path at the same shapes
                attention.causal_attention(tq, tk, tv, scale=scale).float()
                .reshape(b, t, h, hd).transpose(1, 2).numpy()):
        _rows_close(got, ref)
    einsum = np.asarray(jax_causal(jq, jk, jv, scale=scale), np.float32)
    _rows_close(twin.float().numpy(), einsum.reshape(b, t, h, hd)
                .transpose(0, 2, 1, 3))


def test_probe_paths_agree_on_the_cpu():
    """The attention probe's three paths (production, flash wrapper,
    SDPA) compute one function; the GEMV probe's int8 x int8 step stays
    within its quantization error of the twin."""
    q, k, v = (_bf16(a) for a in _qkv((1, 6, 70, 64), 3, 1))
    for causal in (True, False):
        kk, vv = (k, v) if causal else (k.repeat_interleave(2, 1),
                                        v.repeat_interleave(2, 1))
        outs = {n: f().float() for n, f in
                profile_attention.paths(q, kk, vv, causal).items()}
        for name, o in outs.items():
            assert o.shape == (1, 6, 70, 64)
            _rows_close(o.numpy(), outs["flash"].numpy())
    w = quant.quantize(torch.randn((64, 96), generator=torch.Generator()
                                   .manual_seed(0)) * 0.02)
    x = torch.randn((1, 64), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    got = profile_gemv.int_mm_step(w)(x).float()
    ref = splitk_gemv.int8_splitk_gemv(x, w.values, w.scale).float()
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 3e-2
    assert profile_attention.bound_ms(1, 24, 8, 128, 2048, True) == pytest.approx(
        2 * 24 * 2048 ** 2 * 128 / 989e12 * 1e3)
