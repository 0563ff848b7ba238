"""The twins of the two int4 probe kernels against the JAX Pallas functions
they replace, run in interpret mode on the CPU, and the probes' CPU-side
pieces.

* Row 11, `int4_native_matmul` (scripts/int4_native_probe.py, loaded by
  path; the script runs in interpret mode by default): row-interleaved
  nibbles in int8 storage, row-major and chunk-major (C, K/2, 512), at
  (256, 512) and (512, 1024), levels -8..7.
* Row 13, `matmul_bn` (scripts/sweep_gemv_blocks.py, loaded once: it runs
  its TPU sweep at import, where every configuration fails fast on the CPU
  and prints an error line, which is dropped) under
  `pltpu.force_tpu_interpret_mode()`, int32 and int16 unpacks, bn 512 and
  1024, on bytes of `quant.quantize4`.

Tolerance: one bf16 ulp of each output (2^-7 x |jax|): twin and Pallas
body both add exact f32 products in f32, in another order, and round once.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.ops import quant as jquant

from uniaudio2_tpu_torch.ops import int4_native, int4_sweep, quant
from uniaudio2_tpu_torch.probes import int4_native_probe, sweep_gemv_blocks

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7


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
    with contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_native():
    return _script("int4_native_probe")


@pytest.fixture(scope="module")
def jax_sweep():
    return _script("sweep_gemv_blocks")


def _within_ulp(got, ref):
    got = got.float().numpy()
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= ULP * np.abs(ref))


def _native_case(k, n, seed):
    rng = np.random.default_rng(seed)
    w4 = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    scale = ((rng.random(n) + 0.5) / 127.0).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((1, k)) * 0.3, jnp.bfloat16)
    return w4, scale, x


@pytest.mark.parametrize("k,n", [(256, 512), (512, 1024)])
@pytest.mark.parametrize("chunked", [False, True])
def test_native_twin_matches_pallas(jax_native, k, n, chunked):
    w4, scale, x = _native_case(k, n, k + n + chunked)
    packed = jax_native.pack_interleaved(w4)
    values = packed
    if chunked:
        values = np.ascontiguousarray(
            packed.reshape(k // 2, n // 512, 512).transpose(1, 0, 2))
    ref = np.asarray(jax_native.int4_native_matmul(
        x, jnp.asarray(values), jnp.asarray(scale)), np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = int4_native.int4_native_matmul(tx, torch.from_numpy(values),
                                         torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    _within_ulp(got, ref)


@pytest.mark.parametrize("mode", ["i32", "i16"])
@pytest.mark.parametrize("bn", [512, 1024])
@pytest.mark.parametrize("k,n", [(256, 1024), (512, 2048)])
def test_sweep_twin_matches_pallas(jax_sweep, mode, bn, k, n):
    rng = np.random.default_rng(k + bn)
    w = jquant.quantize4(jnp.asarray(rng.standard_normal((k, n)),
                                     jnp.bfloat16))
    x = jnp.asarray(rng.standard_normal((3, k)), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_sweep.matmul_bn(x, w.values, w.scale, bn, mode),
                         np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    for form in (0, len(int4_sweep.FORMS) - 1):
        got = int4_sweep.int4_sweep_matmul(
            tx, torch.from_numpy(np.array(w.values)),
            torch.from_numpy(np.array(w.scale)), form)
        _within_ulp(got, ref)


def test_probe_weights_and_twins_agree():
    """The probes' weights come from the port's quantizer: the same levels
    as K-split bytes (row 13), interleaved row-major and chunk-major (row
    11). The three twins compute one product on them, and the interleaved
    twin equals the sweep's."""
    gen = torch.Generator().manual_seed(0)
    w = quant.quantize4(torch.randn((256, 1024), generator=gen) * 0.02)
    wi = quant.to_interleaved(w)
    x = torch.randn((8, 256), generator=gen).to(torch.bfloat16)
    chunked = int4_native_probe.chunk_major(wi.values, 512)
    assert chunked.shape == (2, 128, 512)
    a = int4_native.int4_native_matmul(x, wi.values, wi.scale)
    b = int4_native.int4_native_matmul(x, chunked, wi.scale)
    c = int4_sweep.int4_sweep_matmul(x, w.values, w.scale)
    assert torch.equal(a, b)
    assert (a.float() - c.float()).abs().max() <= ULP * c.float().abs().max()
    assert torch.equal(quant.levels(wi), quant.levels(w))


def test_probe_bounds_and_shapes():
    """The byte bounds the probes print: K x N / 2 weight bytes, the scale,
    x and the bf16 output at 3.35 TB/s (operations at these M stay far
    below it)."""
    assert sweep_gemv_blocks.SHAPES == (
        ("bb_qkv", 3072, 5120), ("bb_attnproj", 3072, 3072),
        ("dec_qkv", 2048, 4096), ("audio_head", 2048, 12300))
    us = [sweep_gemv_blocks.bound_us(k, n, 1) for _, k, n in
          sweep_gemv_blocks.SHAPES]
    assert [round(u, 1) for u in us] == [2.4, 1.4, 1.3, 3.8]
    assert int4_native_probe.SHAPES[-1] == (3072, 8192)
    assert round(sweep_gemv_blocks.bound_us(3072, 8192, 1), 1) == 3.8
    assert len({f.name for f in int4_sweep.FORMS}) == len(int4_sweep.FORMS) \
        <= 12
