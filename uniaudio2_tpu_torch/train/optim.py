"""The optax pieces the trainer composes, in PyTorch: gradient
transformations over trees (nested dicts and lists) of tensors.

* `clip_by_global_norm`: ``g * max / ||g||`` when ``||g|| >= max`` (optax's
  ``(t / norm) * max``; not ``torch.nn.utils.clip_grad_norm_``, which
  divides by ``norm + 1e-6``);
* `adamw`: optax's ``scale_by_adam`` + ``add_decayed_weights`` +
  ``scale_by_learning_rate``, ``-lr(count) * (m_hat / (sqrt(v_hat) + eps) +
  wd * p)`` with the moments in the parameters' dtype and the schedule read
  at the step count before this update;
* `adafactor`: ``optax.adafactor`` (0.2.6) without its block-RMS
  clipping: factored (or, below ``min_dim_size_to_factor``, plain) RMS
  scaling, the learning rate, the parameter-RMS multiply, decoupled
  weight decay;
* `multi_steps`: optax's ``MultiSteps``: a running mean of the gradients,
  the inner update every k-th call and zero updates in between.

Updates are returned, not applied; `apply_updates` adds them to the
parameters in place (the port's train step owns its parameters).

On a mesh the leaves are DTensors (`parallel.mesh.shard_params`). The
elementwise transformations (clipping, AdamW, accumulation) run on them
shard by shard; `global_norm` sums every shard once; a transformation
whose update is not elementwise (Adafactor's factored moments, the lean
AdamW's blocks) runs a leaf at a time on the gathered leaf (`leaf_whole`)
and keeps its shard of the update.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from uniaudio2_tpu_torch.parallel import mesh as meshlib

Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[..., Any]            # init(params, device) -> state
    update: Callable[..., Any]          # update(grads, state, params) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists; other
    objects are leaves), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order JAX flattens a dict tree (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a leaf in float32 (a plain tensor; a DTensor's
    shards each counted once)."""
    if not meshlib.is_dtensor(t):
        return t.float().square().sum()
    from torch.distributed.tensor import DTensor, Partial, Replicate

    local = t.to_local().float().square().sum()
    mesh = t.device_mesh
    places = [Partial() if pl.is_shard() and mesh.size(i) > 1 else Replicate()
              for i, pl in enumerate(t.placements)]
    if all(pl.is_replicate() for pl in places):
        return local
    return DTensor.from_local(local, mesh, places,
                              run_check=False).full_tensor()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(_square_sum(t) for t in tree_leaves(tree)))


def _state_map(fn, s):
    """``fn`` over the tensors of one leaf's optimizer state (tensors in
    tuples and named tuples)."""
    if isinstance(s, torch.Tensor):
        return fn(s)
    if isinstance(s, tuple):
        out = [_state_map(fn, t) for t in s]
        return type(s)(*out) if hasattr(s, "_fields") else tuple(out)
    return s


def place_state(s, p):
    """One leaf's whole optimizer state beside a DTensor parameter: the
    tensors of the parameter's shape placed as it is, the rest whole."""
    if not meshlib.is_dtensor(p):
        return s
    return _state_map(
        lambda t: meshlib.like(t, p) if t.shape == p.shape else t, s)


def leaf_whole(fn, g, s, p):
    """``fn(g, s, p) -> (update, state)`` of one leaf on whole tensors. A
    DTensor leaf is gathered (its gradient, state and parameter), and the
    update comes back placed as the parameter; state tensors of the
    parameter's shape too, the rest (factored moments, scales) whole on
    every rank."""
    if not meshlib.is_dtensor(p):
        return fn(g, s, p)
    upd, s2 = fn(meshlib.whole(g), _state_map(meshlib.whole, s),
                 meshlib.whole(p))
    return meshlib.like(upd, p), place_state(s2, p)


def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place, in the parameter's dtype
    (optax's ``p + u`` rounded to p's dtype)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)


def _f32(x: float) -> float:
    return float(np.float32(x))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params, device="cuda"):
        return tuple(tx.init(params, device) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params, device="cuda"):
        return ()

    def update(updates, state, params=None):
        norm = global_norm(updates)
        clip = norm >= max_norm

        def fn(t):
            return torch.where(clip, (t / norm.to(t.dtype)) * max_norm, t)

        return tree_map(fn, updates), state

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adamw(learning_rate: Union[float, Schedule], *, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    def init(params, device="cuda"):
        zeros = tree_map(lambda p: torch.zeros_like(p, device=device), params)
        return AdamState(0, zeros, tree_map(torch.zeros_like, zeros))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("adamw requires params (weight decay)")
        count = state.count + 1
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        mc = np.float32(1.0) - np.float32(b1) ** np.float32(count)
        vc = np.float32(1.0) - np.float32(b2) ** np.float32(count)
        mu = tree_map(lambda g, m: _f32(1 - b1) * g + _f32(b1) * m,
                      updates, state.mu)
        nu = tree_map(lambda g, v: _f32(1 - b2) * (g * g) + _f32(b2) * v,
                      updates, state.nu)

        def fn(m, v, p):
            upd = (m / float(mc)) / (torch.sqrt(v / float(vc)) + _f32(eps))
            upd = upd + _f32(weight_decay) * p
            return _f32(-lr) * upd

        return tree_map(fn, mu, nu, params), AdamState(count, mu, nu)

    return GradientTransformation(init, update)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: Any


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    def init(params, device="cuda"):
        acc = tree_map(lambda p: torch.zeros_like(p, device=device), params)
        return MultiStepsState(0, 0, inner.init(params, device), acc)

    def update(updates, state, params=None):
        n = state.mini_step
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), updates, state.acc_grads)
        if n != every_k - 1:
            zeros = tree_map(torch.zeros_like, updates)
            return zeros, MultiStepsState(n + 1, state.gradient_step,
                                          state.inner_opt_state, acc)
        final, inner_state = inner.update(acc, state.inner_opt_state, params)
        return final, MultiStepsState(0, state.gradient_step + 1, inner_state,
                                      tree_map(torch.zeros_like, acc))

    return GradientTransformation(init, update)


class AdafactorState(NamedTuple):
    count: int
    v_row: Any      # tree: row statistics of factored leaves, else (1,)
    v_col: Any      # tree: column statistics of factored leaves, else (1,)
    v: Any          # tree: full statistics of unfactored leaves, else (1,)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest dimensions (numpy's argsort order),
    when the smaller of them is at least ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def adafactor(learning_rate: Union[float, Schedule], *,
              min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0,
              multiply_by_parameter_scale: bool = True,
              weight_decay_rate: Optional[float] = None,
              eps: float = 1e-30) -> GradientTransformation:
    """``optax.adafactor(learning_rate, decay_rate=..., weight_decay_rate=...,
    clipping_threshold=None)`` with optax 0.2.6's other defaults (no
    momentum, factored). The statistics keep the parameter's dtype; the
    schedule is read at the step count before this update."""

    def init(params, device="cuda"):
        def leaf(p):
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            zeros = lambda *n: torch.zeros(n, dtype=p.dtype,  # noqa: E731
                                           device=device)
            if dims is None:
                return place_state((zeros(1), zeros(1), zeros(*p.shape)), p)
            d1, d0 = dims
            shape = list(p.shape)
            return (zeros(*(n for i, n in enumerate(shape) if i != d0)),
                    zeros(*(n for i, n in enumerate(shape) if i != d1)),
                    zeros(1))

        trees = tree_map(leaf, params)
        pick = lambda i: tree_map(lambda t: t[i], trees)  # noqa: E731
        return AdafactorState(0, pick(0), pick(1), pick(2))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("adafactor requires params")
        step = np.float32(state.count - decay_offset + 1)
        decay = float(np.float32(1.0) - step ** np.float32(-decay_rate))
        lr = learning_rate(state.count) if callable(learning_rate) \
            else learning_rate

        def leaf(g, s, p):
            v_row, v_col, v = s
            dtype = p.dtype
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            g2 = g * g + eps
            if dims is not None:
                d1, d0 = dims
                v_row = (decay * v_row.float() + (1.0 - decay)
                         * g2.mean(dim=d0).float()).to(dtype)
                v_col = (decay * v_col.float() + (1.0 - decay)
                         * g2.mean(dim=d1).float()).to(dtype)
                rd1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=rd1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = (decay * v.float() + (1.0 - decay) * g2.float()).to(dtype)
                u = g * v ** -0.5
            u = torch.tensor(lr, dtype=g.dtype, device=g.device) * u
            if multiply_by_parameter_scale:
                rms = torch.sqrt(p.square().mean())
                u = u * torch.clamp_min(rms, 1e-3)
            if weight_decay_rate is not None:
                u = u + weight_decay_rate * p
            return -u, (v_row, v_col, v)

        out = tree_map(
            lambda g, r, c, v, p: leaf_whole(leaf, g, (r, c, v), p),
            updates, state.v_row, state.v_col, state.v, params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), AdafactorState(state.count + 1,
                                       *(tree_map(lambda t: t[j], pick(1))
                                         for j in range(3)))

    return GradientTransformation(init, update)
