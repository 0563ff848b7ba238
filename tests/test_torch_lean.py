"""The port's `adamw_lean` (`uniaudio2_tpu_torch/train/lean_opt.py`) and its
fused update (`ops/lean_update.py`) against the JAX package, on the CPU.

Tolerances:
* the fused update's twin against JAX's Pallas kernel in interpret mode:
  identical bits (upd, m_q, m_scale). XLA compiles the kernel body for the
  CPU with FMAs, b1 moved onto the per-block scale and a product by 1/127;
  the twin rounds exactly so (`ops/lean_update.py`), and so does the CUDA
  kernel (held to the twin in `tests/test_torch_kernels_cuda.py`);
* `adamw_lean` over three steps, fused and plain: updates within 1e-6 x
  max|upd| per leaf, m_q within one int8 step, v.row / v.col within 1e-6
  relative (the row / column means and the plain chain's products are
  summed and rounded in another order than XLA's);
* the optax pieces (`train/optim.py`): 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uniaudio2_tpu.ops import lean_update as jlu
from uniaudio2_tpu.train import lean_opt as jlean
from uniaudio2_tpu.train import schedule as jsched
from uniaudio2_tpu.train import trainer as jtrainer

from uniaudio2_tpu_torch.convert.from_jax import convert_lean_state, to_tensor
from uniaudio2_tpu_torch.ops import lean_update as tlu
from uniaudio2_tpu_torch.train import lean_opt as tlean
from uniaudio2_tpu_torch.train import optim
from uniaudio2_tpu_torch.train import schedule as tsched
from uniaudio2_tpu_torch.train import trainer as ttrainer

UPD_TOL = 1e-6        # x max|upd| of the leaf
V_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return to_tensor(a, "cpu")


def _leaf_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    nsb = shape[-1] // 256
    return dict(
        g=jnp.asarray(rng.standard_normal(shape) * 0.05, dtype),
        m_q=jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
        m_scale=jnp.asarray(np.abs(rng.standard_normal(shape[:-1] + (nsb,)))
                            * 1e-3, jnp.float32),
        p=jnp.asarray(rng.standard_normal(shape) * 0.1, dtype),
        a=jnp.asarray(np.abs(rng.standard_normal(shape[:-1])) * 10 + 1,
                      jnp.float32),
        b=jnp.asarray(np.abs(rng.standard_normal(shape[:-2] + shape[-1:]))
                      * 1e-2, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 256), (2, 24, 512), (16, 1024),
                                   (28, 768)])
def test_fused_twin_identical_to_pallas_interpret(shape, dtype):
    x = _leaf_inputs(shape, jnp.dtype(dtype), seed=len(shape) + shape[-1])
    inv_mc, lr = np.float32(1.0) / np.float32(1 - 0.9 ** 3), np.float32(3e-4)
    kw = dict(b1=0.9, wd=0.01, eps=1e-8)
    ref = jlu.fused_lean_update(*x.values(), jnp.float32(inv_mc),
                                jnp.float32(lr), interpret=True, **kw)
    args = [_t(v) for v in x.values()]
    before = tlu.fused_lean_update.launches
    out = tlu.fused_lean_update(*args, float(inv_mc), float(lr), **kw)
    assert tlu.fused_lean_update.launches == before   # the twin, not a launch
    for name, o, r in zip(("upd", "m_q", "m_scale"), out, ref):
        r = _t(r)
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o.view(-1), r.view(-1)), (
            name, int((o.view(-1) != r.view(-1)).sum()))


def test_tile_sizes_match_jax():
    for r, c in [(3072, 8192), (98400, 3072), (32256, 3072), (24, 512),
                 (2048, 12300), (3072, 5120), (28, 3072), (1030, 256),
                 (1033, 512), (2, 0)]:
        assert tlu.tile_sizes(r, c) == jlu.tile_sizes(r, c), (r, c)


def test_fused_update_refuses_untileable_leaves():
    z = torch.zeros(4, 300)
    with pytest.raises(ValueError):
        tlu.fused_lean_update(z, z.to(torch.int8), torch.zeros(4, 1), z,
                              torch.ones(4), torch.ones(300), 1.0, 1e-3,
                              b1=0.9, wd=0.0, eps=1e-8)


@pytest.mark.parametrize("shape", [(7,), (512,), (12, 47), (3, 130, 512),
                                   (5, 300), ()])
def test_moment_quantization_identical(shape):
    m = (np.random.default_rng(0).standard_normal(shape) * 0.01).astype(np.float32)
    jq, js = jlean._quant_m(jnp.asarray(m))
    tq, ts = tlean._quant_m(torch.from_numpy(np.array(m)))
    assert torch.equal(tq, _t(jq)) and torch.equal(ts, _t(js))
    assert torch.equal(tlean._dequant_m(tq, ts), _t(jlean._dequant_m(jq, js)))


def _tree(rng):
    """A rank-1 leaf, a leaf whose last axis is not a multiple of 256, a
    stacked 3-D leaf and a plain fused leaf."""
    return {"gain": rng.standard_normal((64,)) * 0.1,
            "odd": rng.standard_normal((16, 300)) * 0.1,
            "stack": {"w": rng.standard_normal((3, 8, 512)) * 0.1},
            "w": rng.standard_normal((40, 256)) * 0.1}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(np.array(tree, np.float32))


def _close_tree(t_tree, j_tree, tol):
    for t, j in zip(optim.tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=tol * max(np.abs(j).max(), 1e-30))


def _leaf_pairs(t_state, j_state):
    jl = jax.tree.leaves(j_state.leaves,
                         is_leaf=lambda x: isinstance(x, jlean._LeafState))
    return list(zip(optim.tree_leaves(t_state.leaves), jl))


def _check_state(t_state, j_state):
    assert t_state.count == int(j_state.count)
    for ts, js in _leaf_pairs(t_state, j_state):
        assert int((ts.m_q.int() - _t(js.m_q).int()).abs().max()) <= 1
        if isinstance(ts.v, tlean._FactoredV):
            for t, j in ((ts.v.row, js.v.row), (ts.v.col, js.v.col)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=V_RTOL)
        else:
            np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v),
                                       rtol=V_RTOL)


def _run_both(fused, steps=3, swap_after=None):
    """``steps`` updates of both optimizers on the same gradients; with
    ``swap_after``, the port takes JAX's state and params at that step
    (`convert_lean_state`) before going on."""
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.01, fused=fused)
    jtx = jlean.adamw_lean(jsched.warmup_lr(1e-2, 2), **kw)
    ttx = tlean.adamw_lean(tsched.warmup_lr(1e-2, 2), **kw)
    jp, tp = _as(p0, jnp.asarray), _as(p0, torch.from_numpy)
    jst, tst = jtx.init(jp), ttx.init(tp, device="cpu")
    for i, g in enumerate(grads):
        if swap_after is not None and i == swap_after:
            tst = convert_lean_state(jst, "cpu")
            tp = _as(jp, torch.from_numpy)
        ju, jst = jtx.update(_as(g, jnp.asarray), jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update(_as(g, torch.from_numpy), tst, tp)
        optim.apply_updates(tp, tu)
        _close_tree(tu, ju, UPD_TOL)
        _check_state(tst, jst)
    _close_tree(tp, jp, UPD_TOL)
    return tst, jst


@pytest.mark.parametrize("fused", ["on", "off"])
def test_adamw_lean_matches_jax(fused):
    tst, _ = _run_both(fused)
    routed = [tlean.fused_leaf(torch.zeros(s.m_q.shape), s)
              for s in optim.tree_leaves(tst.leaves)]
    assert sum(routed) == 2          # the stacked leaf and "w"


def test_convert_lean_state_then_step():
    """JAX's state after step 2 carried into the port; step 3 agrees."""
    _run_both("on", steps=3, swap_after=2)


def test_state_bytes_lean():
    params = {"w": torch.zeros((512, 384), dtype=torch.bfloat16),
              "s": torch.zeros((1024,), dtype=torch.bfloat16)}
    st = tlean.adamw_lean(1e-3).init(params, device="cpu")
    assert tlean.state_bytes(st) / (512 * 384 + 1024) < 1.3


def test_fused_mode_routing():
    """"auto" takes the plain chain on CPU leaves (as the JAX package's
    auto is off on the CPU); "on" takes the fused math; unknown values
    raise."""
    assert tlean._resolve_fused("auto") == "auto"
    with pytest.raises(ValueError):
        tlean._resolve_fused("sometimes")
    p = {"w": torch.full((4, 256), 0.5)}
    g = {"w": torch.full((4, 256), 0.01)}
    outs = {}
    for mode in ("auto", "off", "on"):
        tx = tlean.adamw_lean(1e-2, fused=mode)
        outs[mode], _ = tx.update(g, tx.init(p, device="cpu"), p)
    assert torch.equal(outs["auto"]["w"], outs["off"]["w"])


@pytest.mark.parametrize("accum", [1, 2])
def test_clip_adamw_and_accumulation_match_optax(accum):
    """`make_optimizer` with AdamW: clip_by_global_norm + adamw (+
    MultiSteps) against optax, float32."""
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    jtx = jtrainer.make_optimizer(jsched.warmup_lr(1e-2, 3), grad_clip=0.5,
                                  accum_steps=accum)
    ttx = ttrainer.make_optimizer(tsched.warmup_lr(1e-2, 3), grad_clip=0.5,
                                  accum_steps=accum)
    jp, tp = _as(p0, jnp.asarray), _as(p0, torch.from_numpy)
    jst, tst = jtx.init(jp), ttx.init(tp, device="cpu")
    for _ in range(4):
        g = _tree(rng)
        ju, jst = jtx.update(_as(g, jnp.asarray), jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update(_as(g, torch.from_numpy), tst, tp)
        optim.apply_updates(tp, tu)
        _close_tree(tu, ju, UPD_TOL)
    _close_tree(tp, jp, UPD_TOL)
    np.testing.assert_allclose(
        float(optim.global_norm(_as(g, torch.from_numpy))),
        float(optax.global_norm(_as(g, jnp.asarray))), rtol=1e-6)


def test_accumulation_emits_zero_between_steps():
    params = {"w": torch.ones((8, 256)), "b": torch.zeros((4,))}
    tx = ttrainer.make_optimizer(tsched.warmup_lr(1e-3, 2), grad_clip=1.0,
                                 accum_steps=2, optimizer="adamw_lean")
    st = tx.init(params, device="cpu")
    g = optim.tree_map(torch.ones_like, params)
    upd1, st = tx.update(g, st, params)
    assert float(upd1["w"].abs().max()) == 0.0
    upd2, st = tx.update(g, st, params)
    assert float(upd2["w"].abs().max()) > 0.0
    # adafactor, once refused here: one update equal to JAX's optimizer
    ttx = ttrainer.make_optimizer(1e-3, optimizer="adafactor")
    jtx = jtrainer.make_optimizer(1e-3, optimizer="adafactor")
    tu, _ = ttx.update(g, ttx.init(params, device="cpu"), params)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    ju, _ = jtx.update({k: jnp.ones_like(v) for k, v in jp.items()},
                       jtx.init(jp), jp)
    for k in params:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-6, err_msg=k)
