"""Row 14 of the TPU kernel table, the stacked-layer int4 GEMV with a device
layer index, against the JAX probe it replaces (`scripts/profile_scan_slice.py`,
loaded by path and run at a small size on the CPU).

The probe's module globals are set to (L, K, N, ITERS) = (3, 256, 512, 1)
and its `timed` / `report` replaced by functions that keep each chain's
output; `main()` runs under `pltpu.force_tpu_interpret_mode()`, so its
``prefetch`` variant runs the Pallas kernel's body in interpret mode and
``scan`` / ``unrolled`` take the JAX package's `quant.matmul`. The port's
three chains (`uniaudio2_tpu_torch/probes/profile_scan_slice.py`'s forms)
run on the same weights, JAX's `quantize4` of ``PRNGKey(i)`` normals
converted through `convert/from_jax.py`, through the CPU twins.

The wrappers of row 14 (the TMA ring and its first design) refuse what
their kernels do not take before any plan or launch (meta tensors).

Tolerance: one bf16 ulp of the output's range a layer, L x 2^-7 x
max|jax| for a chain of L layers. Twin and Pallas body add exact f32
products in f32 in another order and round once a layer; the XLA fallback
rounds the scaled weights to bf16 first (2^-9 relative each), which moves
an output by far less than one ulp of its range.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from uniaudio2_tpu.ops import quant as jquant

from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.ops import int4_stacked, quant
from uniaudio2_tpu_torch.probes import profile_scan_slice as probe

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7
L, K, N = 3, 256, 512


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX probe's three chains at (3, 256, 512), one pass each, and
    the lines it printed."""
    spec = importlib.util.spec_from_file_location(
        "_jax_profile_scan_slice", ROOT / "scripts" / "profile_scan_slice.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.L, mod.K, mod.N, mod.ITERS = L, K, N, 1
    outs = {}
    last = []

    def timed(fn, w, x):
        last[:] = [np.asarray(fn(w, x), np.float32)]
        return 1.0

    def report(name, dt):
        outs[name] = last[0]

    mod.timed, mod.report = timed, report
    printed = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(printed):
        mod.main()
    lines = [json.loads(s) for s in printed.getvalue().splitlines() if s]
    return outs, lines


@pytest.fixture(scope="module")
def port_weights():
    """The JAX probe's weights, through the bridge: the stacked container
    and the 28 (here 3) separate ones."""
    ws = [jquant.quantize4(jax.random.normal(jax.random.PRNGKey(i), (K, N),
                                             jnp.float32).astype(jnp.bfloat16))
          for i in range(L)]
    stacked = jquant.QuantizedLinear4(jnp.stack([w.values for w in ws]),
                                      jnp.stack([w.scale for w in ws]))
    return ws, convert_params(stacked, "cpu"), convert_params(ws, "cpu")


@pytest.fixture(autouse=True)
def small_probe(monkeypatch):
    for name, v in (("L", L), ("K", K), ("N", N)):
        monkeypatch.setattr(probe, name, v)


def _port_chain(stacked, layers, name):
    forms = probe.Forms(stacked, layers, "cpu")
    forms.run_pass(name)
    return forms.x.float().numpy()


def test_prefetch_variant_ran(jax_run):
    """The JAX probe's prefetch variant printed no error line: its Pallas
    kernel ran in interpret mode."""
    outs, lines = jax_run
    assert set(outs) == {"scan", "unrolled", "prefetch"}
    assert not [ln for ln in lines if "error" in ln], lines


@pytest.mark.parametrize("name", ["scan", "unrolled", "prefetch"])
def test_chain_matches_jax(jax_run, port_weights, name):
    """Each of the port's chains against the JAX variant of its name: one
    bf16 ulp of the range a layer."""
    outs, _ = jax_run
    _, stacked, layers = port_weights
    ref = outs[name]
    got = _port_chain(stacked, layers, name)
    assert got.shape == ref.shape == (1, K)
    assert np.abs(got - ref).max() <= L * ULP * np.abs(ref).max()
    assert np.abs(ref).max() > 0


def test_one_layer_form_walks_the_stack(port_weights):
    """The one-layer body (row 14 at the device index, then index + 1 mod
    L), run L times, gives the prefetch chain's bits."""
    _, stacked, layers = port_weights
    forms = probe.Forms(stacked, layers, "cpu")
    for _ in range(L):
        forms.one_layer()
    assert int(forms.layer[0]) == 0
    np.testing.assert_array_equal(forms.x.float().numpy(),
                                  _port_chain(stacked, layers, "prefetch"))


@pytest.mark.parametrize("layer", range(L))
def test_twin_matches_jax_matmul_per_layer(port_weights, layer):
    """Each layer's twin output, with the index as an int and as a tensor,
    against JAX's `quant.matmul` on that layer's slice: one bf16 ulp of the
    range."""
    ws, stacked, _ = port_weights
    rng = np.random.default_rng(layer)
    x = jnp.asarray(rng.standard_normal((2, K)), jnp.bfloat16)
    ref = np.asarray(jquant.matmul(x, ws[layer]), np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    for idx in (layer, torch.tensor([layer], dtype=torch.int32)):
        got = int4_stacked.int4_stacked_matmul(tx, stacked, idx)
        assert got.dtype == torch.bfloat16 and got.shape == (2, N)
        assert np.abs(got.float().numpy() - ref).max() <= \
            ULP * np.abs(ref).max()


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


BF, I8, F32, I32 = torch.bfloat16, torch.int8, torch.float32, torch.int32
# (x, values, scale, layer): each one thing the kernels do not take; the
# layer None is the int 0
REFUSED = {
    "layer an int": ((1, 256, BF), (3, 128, 512, I8), (3, 512, F32), None),
    "layer int64": ((1, 256, BF), (3, 128, 512, I8), (3, 512, F32),
                    (1, torch.int64)),
    "layer two elements": ((1, 256, BF), (3, 128, 512, I8), (3, 512, F32),
                           (2, I32)),
    "ldw 96": ((1, 256, BF), (3, 128, 96, I8), (3, 96, F32), (1, I32)),
    "values 2-D": ((1, 256, BF), (128, 512, I8), (3, 512, F32), (1, I32)),
    "scale of 2 layers": ((1, 256, BF), (3, 128, 512, I8), (2, 512, F32),
                          (1, I32)),
    "K/2 rows wrong": ((1, 256, BF), (3, 64, 512, I8), (3, 512, F32),
                       (1, I32)),
    "x float32": ((1, 256, F32), (3, 128, 512, I8), (3, 512, F32), (1, I32)),
    "scale bf16": ((1, 256, BF), (3, 128, 512, I8), (3, 512, BF), (1, I32)),
}


@pytest.mark.parametrize("case", list(REFUSED))
@pytest.mark.parametrize("fn", [int4_stacked.int4_stacked_matmul,
                                int4_stacked.int4_stacked_matmul_simt],
                         ids=lambda f: f.__name__)
def test_wrappers_refuse_before_the_plan(fn, case):
    """A card-side call on operands the kernels do not take raises
    ValueError before any plan or launch (meta tensors: nothing is built,
    no card is asked for its SMs)."""
    xs, vs, ss, ls = REFUSED[case]
    stacked = quant.QuantizedLinear4(_meta(*vs[:-1], dtype=vs[-1]),
                                     _meta(*ss[:-1], dtype=ss[-1]))
    layer = 0 if ls is None else _meta(ls[0], dtype=ls[1])
    with pytest.raises(ValueError):
        fn(_meta(*xs[:-1], dtype=xs[-1]), stacked, layer)


def test_wrapper_rejects_what_the_kernel_does_not_take(port_weights):
    _, stacked, layers = port_weights
    x = torch.ones((1, K), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        int4_stacked.int4_stacked_matmul(x, layers[0], 0)      # not stacked
    with pytest.raises(ValueError):
        int4_stacked.int4_stacked_matmul(torch.ones((1, 2 * K),
                                                    dtype=torch.bfloat16),
                                         stacked, 0)
