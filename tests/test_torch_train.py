"""The port's training forward, loss, gradients and train step
(`uniaudio2_tpu_torch/models/unified.py`, `train/trainer.py`) against the
JAX package on `UnifiedModelConfig.tiny()` in float32, JAX at matmul
precision "highest" (tests/conftest.py).

Tolerances:
* forward: text / audio logits and the hidden pair within
  `tests/test_torch_models.py`'s TOL (rtol / atol 1e-4);
* loss: 1e-5 relative; every leaf's gradient within 1e-4 x max|grad| of
  the leaf (summation order differs across the whole model);
* train steps: per-step loss and grad_norm within 1e-5 relative; final
  parameters within 1e-5 x max|p| per leaf, except where an int8
  first-moment element rounded to the other neighbour. The gradients agree
  to about 1e-6, not to the bit, so m / scale can fall on either side of a
  rounding boundary; such an element's update moves by one int8 step of
  the moment, lr * m_scale / sqrt(v_hat), about 1e-3 x max|p| at most at
  these sizes. Those elements are counted: at most 0.1 % of the
  parameters, each within 1e-3 x max|p|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.train import schedule as jsched
from uniaudio2_tpu.train import trainer as jtrainer

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.train import optim
from uniaudio2_tpu_torch.train import schedule as tsched
from uniaudio2_tpu_torch.train import trainer

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # x max|grad| of the leaf
PARAM_TOL = 1e-5       # x max|p| of the leaf
FLIP_TOL = 1e-3        # x max|p|, an element whose int8 moment rounded apart
FLIP_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(0), jcfg)
    b, s, par, ncb = 2, 16, 9, 8
    r = np.random.default_rng(0)
    grid = r.integers(0, 50, size=(b, s + 1, par)).astype(np.int32)
    gmask = np.zeros((b, s + 1, par), bool)
    gmask[:, : s // 2, -1] = True
    gmask[:, s // 2:, :ncb] = True
    gmask[1, 3, :ncb] = True                   # a mixed step
    tmask = np.zeros((b, s), bool)
    tmask[:, 1: s // 2] = True
    amask = np.zeros((b, s), bool)
    amask[:, s // 2: s - 1] = True
    amask[1, s - 1] = True
    arrays = (grid, gmask, tmask, amask)
    jb = jtrainer.Batch(*(jnp.asarray(a) for a in arrays))
    tb = trainer.Batch(*(torch.from_numpy(a) for a in arrays))
    return jcfg, jp, UnifiedModelConfig.tiny(), jb, tb


def _fresh(jp):
    return convert_params(jp, "cpu")


@pytest.mark.parametrize("case", ["plain", "prefix_lm", "decoder_positions"])
def test_training_forward(setup, case):
    jcfg, jp, tcfg, jb, tb = setup
    tp = _fresh(jp)
    jkw, tkw = {}, {}
    if case == "prefix_lm":
        from uniaudio2_tpu.train.masks import prefix_lm_mask as jmask
        from uniaudio2_tpu_torch.train.masks import prefix_lm_mask as tmask
        jkw["extra_mask"] = jmask(jb.text_loss_mask | jb.audio_loss_mask)
        tkw["extra_mask"] = tmask(tb.text_loss_mask | tb.audio_loss_mask)
    if case == "decoder_positions":
        jpos, _ = jtrainer.audio_gather_indices(jb.audio_loss_mask, 10)
        tpos, _ = trainer.audio_gather_indices(tb.audio_loss_mask, 10)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        jkw["decoder_positions"], tkw["decoder_positions"] = jpos, tpos
    args_j = (jb.grid[:, :-1], jb.grid[:, 1:, :8], jb.grid_mask)
    args_t = (tb.grid[:, :-1], tb.grid[:, 1:, :8], tb.grid_mask)
    for hidden in (False, True):
        jout = junified.forward(jp, jcfg, *args_j, return_hidden=hidden, **jkw)
        with torch.no_grad():
            tout = unified.forward(tp, tcfg, *args_t, return_hidden=hidden,
                                   remat_layers=hidden, **tkw)
        for t, j in zip(tout, jout):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _grads(params, cfg, batch, **kw):
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = trainer.loss_fn(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def test_loss_and_gradients(setup):
    jcfg, jp, tcfg, jb, tb = setup
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtrainer.loss_fn(p, jcfg, jb, prefix_lm=True,
                                   audio_capacity=12), has_aux=True)(jp)
    tl, tm, tg = _grads(_fresh(jp), tcfg, tb, prefix_lm=True, remat=True,
                        audio_capacity=12)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for t, j in zip(tg, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max())


def test_remat_does_not_change_loss_or_gradients(setup):
    """Checkpointing recomputes the same operations: full, selective and
    no remat give the same loss and gradients."""
    _, jp, tcfg, _, tb = setup
    runs = [_grads(_fresh(jp), tcfg, tb, prefix_lm=True, **kw) for kw in (
        dict(remat=True), dict(remat=False),
        dict(remat=True, remat_backbone=1, remat_small=False))]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][2]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(setup, accum):
    jcfg, jp, tcfg, jb, tb = setup
    jtx = jtrainer.make_optimizer(jsched.warmup_lr(1e-3, 2), grad_clip=1.0,
                                  accum_steps=accum, optimizer="adamw_lean",
                                  lean_fused="on")
    ttx = trainer.make_optimizer(tsched.warmup_lr(1e-3, 2), grad_clip=1.0,
                                 accum_steps=accum, optimizer="adamw_lean",
                                 lean_fused="on")
    jstep = jax.jit(jtrainer.build_train_step(jcfg, jtx, remat=True))
    tstep = trainer.build_train_step(tcfg, ttx, remat=True)
    jst = jtrainer.init_train_state(jp, jtx)
    tst = trainer.init_train_state(_fresh(jp), ttx, device="cpu")
    for _ in range(3):
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert tst.step == int(jst.step) == 3
    flips, total = 0, 0
    for t, j in zip(optim.tree_leaves(tst.params), jax.tree.leaves(jst.params)):
        j = np.asarray(j)
        scale = np.abs(j).max()
        err = np.abs(t.numpy() - j)
        assert err.max() <= FLIP_TOL * scale
        flips += int((err > PARAM_TOL * scale).sum())
        total += j.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_train_step_dense_path_matches_fused(setup):
    """chunked_ce=False (dense logits, the whole loss checkpointed) gives
    the fused path's loss and gradient norm."""
    _, jp, tcfg, _, tb = setup
    out = []
    for chunked in (True, False):
        tx = trainer.make_optimizer(tsched.warmup_lr(1e-3, 2),
                                    optimizer="adamw")
        step = trainer.build_train_step(tcfg, tx, chunked_ce=chunked)
        _, m = step(trainer.init_train_state(_fresh(jp), tx, device="cpu"), tb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)
