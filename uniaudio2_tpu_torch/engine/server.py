"""Dynamic-batching serving front end (port of `uniaudio2_tpu/engine/server.py`).

The reference serves strictly batch 1 from a CLI loop
(`multi_task_inference.py:258-553`); its only batching is offline file
iteration. A decode frame at batch 1 streams every weight for one row, so
batching rows into one frame loop multiplies throughput. This module puts
the runtime piece a deployment needs on top of the batched frame loop
(`decode.py::generate_{text,audio}_batch`): a request queue, a grouping
batcher, and futures.

Design (host-side and deliberately simple; the device work is all inside
the engine):

* `submit()` enqueues a request and returns a `concurrent.futures.Future`.
* A single worker thread drains the queue: requests are grouped by
  *program compatibility key*, (mode, temperature, topk, use_cfg,
  cfg_scale), the sampling arguments one frame program holds; within a
  group, up to ``max_batch`` requests launch as one batched decode (ragged
  prompts are bucketed and left-packed by the engine).
* A group launches when it reaches ``max_batch`` or its oldest request has
  waited ``max_wait_ms`` (classic dynamic batching).
* Per-request seeds: every request samples from its own row stream
  (`DecodeEngine.generate_*_batch(seeds=...)`, `ops.sampling.RowKeys`), so
  a sampled request's output does not depend on which other requests share
  its batch (within one bucket); greedy ``topk=1`` is deterministic.

Threads: the worker is the only thread that touches the device. It sets
the engine's device as its current one and every engine call takes and
returns host (numpy) arrays, so `submit` may be called from any thread and
no submitting thread makes a CUDA call. That matters on the card: the
engine captures its frame graphs lazily, on a request, and a CUDA call
from another thread during a capture breaks it.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class _Request:
    mode: str                   # "text" | "audio"
    grid: np.ndarray
    mask: np.ndarray
    params: Tuple              # compatibility key (see _key)
    seed: int
    future: Future = field(default_factory=Future)
    neg: Optional[Tuple[np.ndarray, np.ndarray]] = None
    enqueued_at: float = field(default_factory=time.monotonic)


class BatchingServer:
    """Dynamic batcher over a `DecodeEngine`.

    Args:
        engine: a `uniaudio2_tpu_torch.engine.decode.DecodeEngine`.
        max_batch: largest request group launched as one batched program.
        max_wait_ms: longest a request waits for batch-mates before its
            group launches anyway.
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: Dict[Tuple, List[_Request]] = {}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        self._stats_lock = threading.Lock()   # submitters count requests

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingServer":
        if self._worker is not None:
            raise RuntimeError("the server is already started")
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        return self

    def stop(self, drain: bool = True):
        if drain:
            self._queue.join()
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(
        self,
        mode: str,
        grid: np.ndarray,
        mask: np.ndarray,
        *,
        temperature: float = 0.9,
        topk: Optional[int] = None,
        seed: int = 888,
        use_cfg: bool = False,
        cfg_scale: float = 1.0,
        neg_grid: Optional[np.ndarray] = None,
        neg_mask: Optional[np.ndarray] = None,
    ) -> Future:
        """Enqueue one request; resolves to the same value the corresponding
        `DecodeEngine.generate_{text,audio}` call would return."""
        if mode not in ("text", "audio"):
            raise ValueError(f"mode {mode!r}: expected text or audio")
        if topk is None:
            topk = 1 if mode == "text" else 200
        if use_cfg and (neg_grid is None or neg_mask is None):
            raise ValueError("use_cfg needs neg_grid and neg_mask")
        req = _Request(
            mode=mode, grid=np.asarray(grid), mask=np.asarray(mask),
            params=(mode, float(temperature), int(topk), bool(use_cfg),
                    float(cfg_scale)),
            seed=seed,
            neg=(np.asarray(neg_grid), np.asarray(neg_mask))
            if use_cfg else None,
        )
        with self._stats_lock:
            self.stats["requests"] += 1
        self._queue.put(req)
        return req.future

    # -- worker ------------------------------------------------------------

    def _run(self):
        device = self.engine.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            try:
                req = self._queue.get(timeout=0.01)
            except queue.Empty:
                self._flush_expired()
                continue
            self._pending.setdefault(req.params, []).append(req)
            group = self._pending[req.params]
            if len(group) >= self.max_batch:
                self._launch(req.params)
            else:
                self._flush_expired()
        # final drain on stop
        while True:
            try:
                req = self._queue.get_nowait()
                self._pending.setdefault(req.params, []).append(req)
            except queue.Empty:
                break
        for key in list(self._pending):
            self._launch(key)

    def _flush_expired(self):
        now = time.monotonic()
        for key, group in list(self._pending.items()):
            if group and (now - group[0].enqueued_at) * 1e3 >= self.max_wait_ms:
                self._launch(key)

    def _launch(self, key: Tuple):
        group = self._pending.pop(key, [])
        if not group:
            return
        mode, temperature, topk, use_cfg, cfg_scale = key
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(group)
        items = [(r.grid, r.mask) for r in group]
        try:
            seeds = [r.seed for r in group]
            if mode == "text":
                outs = self.engine.generate_text_batch(
                    items, temperature=temperature, topk=topk, seeds=seeds,
                )
            else:
                outs = self.engine.generate_audio_batch(
                    items, temperature=temperature, topk=topk, seeds=seeds,
                    use_cfg=use_cfg, cfg_scale=cfg_scale,
                    neg_items=[r.neg for r in group] if use_cfg else None,
                )
            for r, out in zip(group, outs):
                r.future.set_result(out)
        except Exception as e:  # surface decode failures to every waiter
            for r in group:
                r.future.set_exception(e)
        finally:
            for _ in group:
                self._queue.task_done()
