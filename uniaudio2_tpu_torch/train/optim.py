"""The optax pieces the trainer composes, in PyTorch: gradient
transformations over trees (nested dicts and lists) of tensors.

* `clip_by_global_norm`: ``g * max / ||g||`` when ``||g|| >= max`` (optax's
  ``(t / norm) * max``; not ``torch.nn.utils.clip_grad_norm_``, which
  divides by ``norm + 1e-6``);
* `adamw`: optax's ``scale_by_adam`` + ``add_decayed_weights`` +
  ``scale_by_learning_rate``, ``-lr(count) * (m_hat / (sqrt(v_hat) + eps) +
  wd * p)`` with the moments in the parameters' dtype and the schedule read
  at the step count before this update;
* `multi_steps`: optax's ``MultiSteps``: a running mean of the gradients,
  the inner update every k-th call and zero updates in between.

Updates are returned, not applied; `apply_updates` adds them to the
parameters in place (the port's train step owns its parameters).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree_leaves(tree)))


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
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                               device=device), params)
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
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                             device=device), params)
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
