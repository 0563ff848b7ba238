"""Learning-rate schedules (port of `uniaudio2_tpu/train/schedule.py`), as
plain functions of an int step that return the rate as a float holding a
float32 value (the JAX schedules compute in float32).

``warmup_lr`` is the reference's `WarmupLR`
(reference `llm_utils/train_utils.py:207-244`):
``lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5)`` with ``s = step + 1``,
so the peak equals the base lr at ``step + 1 == warmup_steps``.
``cosine_lr`` is optax's ``warmup_cosine_decay_schedule``: a linear warmup
from 0 to the peak, then cosine decay to ``end_scale * lr`` at
``total_steps``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np

Schedule = Callable[[int], float]
_f = np.float32


def warmup_lr(base_lr: float, warmup_steps: int = 25000) -> Schedule:
    w = float(warmup_steps)

    def schedule(step: int) -> float:
        s = max(_f(step) + _f(1.0), _f(1.0))
        return float(_f(base_lr * (w ** 0.5))
                     * min(s ** _f(-0.5), s * _f(w ** -1.5)))

    return schedule


def noam_lr(base_lr: float, model_size: int, warmup_steps: int = 25000) -> Schedule:
    w = float(warmup_steps)

    def schedule(step: int) -> float:
        s = max(_f(step) + _f(1.0), _f(1.0))
        return float(_f(base_lr * (model_size ** -0.5))
                     * min(s ** _f(-0.5), s * _f(w ** -1.5)))

    return schedule


def cosine_lr(base_lr: float, warmup_steps: int, total_steps: int,
              end_scale: float = 0.1) -> Schedule:
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"cosine_lr needs total_steps > warmup_steps, got "
                         f"{total_steps} <= {warmup_steps}")
    alpha = 0.0 if base_lr == 0.0 else base_lr * end_scale / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:        # linear from 0 to the peak
            frac = _f(1.0) - _f(min(max(step, 0), warmup_steps)) / _f(warmup_steps)
            return float(_f(0.0 - base_lr) * frac + _f(base_lr))
        t = _f(min(step - warmup_steps, decay_steps))
        cosine = _f(0.5) * (_f(1.0) + _f(math.cos(float(_f(math.pi) * t
                                                         / _f(decay_steps)))))
        return float(_f(base_lr) * (_f(1.0 - alpha) * cosine + _f(alpha)))

    return schedule


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "noamlr": noam_lr,
    "cosine": cosine_lr,
}


def get_schedule(name: str, **kwargs) -> Schedule:
    key = name.lower()
    if key not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; known: {sorted(SCHEDULES)}")
    return SCHEDULES[key](**kwargs)
