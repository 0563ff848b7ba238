"""Training metrics aggregation and logging sinks (a copy of
`uniaudio2_tpu/train/reporter.py`, which imports nothing of JAX).

Capability parity with the reference ESPnet-style Reporter
(reference `llm_utils/reporter.py:103-581`): per-batch stat
registration with (weighted) averaging, windowed mid-epoch logging, an epoch
store queryable for best epochs, serializable state, and TensorBoard / wandb
sinks (both optional, gated on import — reference `:222,235`).

Functional-lite design: one small class, plain dicts for state.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


class SubReporter:
    """Accumulates stats within one epoch; supports windowed log lines."""

    def __init__(self, key: str, epoch: int):
        self.key = key
        self.epoch = epoch
        self._sums: Dict[str, float] = defaultdict(float)
        self._weights: Dict[str, float] = defaultdict(float)
        self._window_sums: Dict[str, float] = defaultdict(float)
        self._window_counts: Dict[str, float] = defaultdict(float)
        self.steps = 0
        self._start = time.time()

    def register(self, stats: Dict[str, float], weight: float = 1.0) -> None:
        self.steps += 1
        for name, value in stats.items():
            if value is None:
                continue
            v = float(value)
            if math.isnan(v):
                continue
            self._sums[name] += v * weight
            self._weights[name] += weight
            self._window_sums[name] += v
            self._window_counts[name] += 1.0

    def window_message(self, reset: bool = True) -> str:
        parts = [
            f"{name}={self._window_sums[name] / max(c, 1.0):.4f}"
            for name, c in self._window_counts.items()
        ]
        msg = (
            f"[{self.key}] epoch {self.epoch} step {self.steps} "
            + " ".join(parts)
        )
        if reset:
            self._window_sums.clear()
            self._window_counts.clear()
        return msg

    def finish(self) -> Dict[str, float]:
        out = {
            name: self._sums[name] / max(self._weights[name], 1e-12)
            for name in self._sums
        }
        out["time"] = time.time() - self._start
        return out


class Reporter:
    """Epoch store + sink fan-out."""

    def __init__(self, use_tensorboard: bool = False, tb_dir: Optional[str] = None,
                 use_wandb: bool = False):
        self.epochs: Dict[int, Dict[str, Dict[str, float]]] = {}
        self.epoch = 0
        self._tb = None
        self._wandb = None
        if use_tensorboard and tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except Exception:  # tensorboard optional
                self._tb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
            except Exception:
                self._wandb = None

    def start_epoch(self, key: str, epoch: int) -> SubReporter:
        self.epoch = max(self.epoch, epoch)
        return SubReporter(key, epoch)

    def finish_epoch(self, sub: SubReporter) -> Dict[str, float]:
        stats = sub.finish()
        self.epochs.setdefault(sub.epoch, {})[sub.key] = stats
        step = sub.epoch
        if self._tb is not None:
            for name, v in stats.items():
                self._tb.add_scalar(f"{sub.key}/{name}", v, step)
        if self._wandb is not None and getattr(self._wandb, "run", None):
            self._wandb.log(
                {f"{sub.key}/{k}": v for k, v in stats.items()}, step=step
            )
        return stats

    def get(self, epoch: int, key: str, name: str) -> float:
        return self.epochs[epoch][key][name]

    def sort_epochs(self, key: str, name: str, mode: str = "min") -> List[Tuple[int, float]]:
        """Epochs sorted by a stat (best first) — best-model selection
        (reference `sort_epochs_and_values`)."""
        assert mode in ("min", "max")
        vals = [
            (e, d[key][name]) for e, d in self.epochs.items()
            if key in d and name in d[key]
        ]
        return sorted(vals, key=lambda x: x[1], reverse=mode == "max")

    def best_epoch(self, key: str, name: str, mode: str = "min") -> int:
        return self.sort_epochs(key, name, mode)[0][0]

    def state_dict(self) -> Dict:
        return {"epochs": self.epochs, "epoch": self.epoch}

    def load_state_dict(self, state: Dict) -> None:
        self.epochs = {int(k): v for k, v in state["epochs"].items()}
        self.epoch = state["epoch"]
