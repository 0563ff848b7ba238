"""Training batch construction: grids, loss masks, length-batching (a
copy of `uniaudio2_tpu/data/batching.py`, which is numpy and Python only;
same seed, same batches).

Bridges the example dicts of `data/loading.py` to the static-shape `Batch`
of `train/trainer.py`:

* ``build_training_grid`` — the training analog of the inference condition
  grid: ALL task-format keys are framed in order (conditioning + targets)
  into one (S, 9) teacher-forcing grid, and per-step loss masks mark the
  ``loss_key`` segments (shifted one step left: position t's loss covers the
  token emitted at t+1 — matching the reference forward's
  input ``tokens[:, :-1]`` / ``labels`` alignment, `model_new.py:402-454`).
* ``LengthBatcher`` — batch-by-total-length with bucketed padding: examples
  are sorted by length and grouped until ``sum(len) > batch_scale``
  (reference ``--batch_scale`` semantics, `llm_utils/arguments.py:19`), then
  padded to the bucket's max length rounded up to a multiple of 64, so
  the model sees few distinct shapes.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from uniaudio2_tpu_torch.config import TokenSpace
from uniaudio2_tpu_torch.engine import tasks as taskmod


def _segment_rows(key: str, tp: str, data, ts: TokenSpace, text_tokenizer):
    """One task-format key -> (rows (T, 9), mask (T, 9), is_audio)."""
    if tp == "text":
        if isinstance(data, str):
            if text_tokenizer is None:
                raise ValueError("raw text needs a tokenizer")
            data = np.asarray(text_tokenizer.tokenize(data), np.int64)
        ids = taskmod.add_special_token(key, np.asarray(data, np.int64), ts)
        rows = taskmod.text_pad(ids, ts)
        mask = np.zeros_like(rows, bool)
        mask[:, -1] = True
        return rows, mask, False
    codes = np.asarray(data, np.int64)
    if codes.shape[0] == ts.num_codebooks and codes.shape[0] != codes.shape[-1]:
        codes = codes.T  # accept (8, T) storage layout
    if tp == "audio_prompt":
        codes = taskmod.semantic_bos_eos(codes, ts)
        codes = taskmod.audio_prompt_bos_eos(codes, ts)
    elif key.startswith("reason_seq"):
        codes = taskmod.reason_bos_eos(codes, ts)
    else:
        codes = taskmod.semantic_bos_eos(codes, ts)
    rows = taskmod.audio_pad(codes, ts)
    mask = np.zeros_like(rows, bool)
    mask[:, :-1] = True
    return rows, mask, True


def build_training_grid(
    example: Mapping[str, Any],
    ts: TokenSpace,
    *,
    text_tokenizer=None,
    task_prompt: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Example dict (from `load_task_dataset`) -> training tensors.

    Returns {"grid": (S, 9), "grid_mask": (S, 9), "text_loss_mask": (S-1,),
    "audio_loss_mask": (S-1,)}.
    """
    task = example["task"]
    fmt = taskmod.TASK_FORMATS[task]
    loss_keys = set(example.get("loss_key", fmt["loss_key"]))

    rows_list: List[np.ndarray] = []
    masks_list: List[np.ndarray] = []
    spans: List[Tuple[str, int, int, bool]] = []
    if task_prompt is not None and len(task_prompt):
        rows = taskmod.text_pad(np.asarray(task_prompt, np.int64), ts)
        m = np.zeros_like(rows, bool)
        m[:, -1] = True
        rows_list.append(rows)
        masks_list.append(m)
    offset = sum(r.shape[0] for r in rows_list)
    for key, tp in zip(fmt["keys"], fmt["type"]):
        rows, mask, is_audio = _segment_rows(
            key, tp, example[key], ts, text_tokenizer
        )
        rows_list.append(rows)
        masks_list.append(mask)
        spans.append((key, offset, offset + rows.shape[0], is_audio))
        offset += rows.shape[0]

    grid = np.concatenate(rows_list, 0)
    gmask = np.concatenate(masks_list, 0)
    s = grid.shape[0]
    text_loss = np.zeros((s,), bool)
    audio_loss = np.zeros((s,), bool)
    for key, a, b, is_audio in spans:
        if key in loss_keys:
            (audio_loss if is_audio else text_loss)[a:b] = True
    # step-level masks: loss at step t covers the token at t+1
    return {
        "grid": grid.astype(np.int32),
        "grid_mask": gmask,
        "text_loss_mask": text_loss[1:],
        "audio_loss_mask": audio_loss[1:],
    }


def _round_up(n: int, k: int = 64) -> int:
    return ((n + k - 1) // k) * k


class LengthBatcher:
    """batch-by-total-length iterator over built training grids."""

    def __init__(
        self,
        examples: Dict[str, Mapping[str, Any]],
        ts: TokenSpace,
        *,
        batch_scale: int = 2048,
        text_tokenizer=None,
        max_length: int = 2048,
        min_length: int = 2,
        pad_multiple: int = 64,
        seed: int = 0,
    ):
        self.ts = ts
        self.batch_scale = batch_scale
        self.tok = text_tokenizer
        self.pad_multiple = pad_multiple
        self.seed = seed
        self._built: List[Dict[str, np.ndarray]] = []
        for eid, ex in examples.items():
            b = build_training_grid(ex, ts, text_tokenizer=text_tokenizer)
            if min_length <= b["grid"].shape[0] <= max_length:
                b["id"] = eid
                self._built.append(b)
        self._built.sort(key=lambda b: b["grid"].shape[0])

    def __len__(self) -> int:
        return len(self._groups())

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yields padded batches; groups are length-sorted, group order is
        shuffled per epoch (reference sampler epoch reshuffle,
        `train_utils.py:153-154`)."""
        groups = self._groups()
        rng = random.Random(self.seed + epoch)
        rng.shuffle(groups)
        for g in groups:
            yield self._pad_group(g)

    def _groups(self) -> List[List[Dict]]:
        """The examples in length order, cut into groups of at most
        ``batch_scale`` steps (a longer example alone)."""
        groups: List[List[Dict]] = []
        cur: List[Dict] = []
        total = 0
        for b in self._built:
            n = b["grid"].shape[0]
            if cur and total + n > self.batch_scale:
                groups.append(cur)
                cur, total = [], 0
            cur.append(b)
            total += n
        if cur:
            groups.append(cur)
        return groups

    def _pad_group(self, group: List[Dict]) -> Dict[str, np.ndarray]:
        s = _round_up(max(b["grid"].shape[0] for b in group), self.pad_multiple)
        n = len(group)
        par = self.ts.parallel_number
        grid = np.zeros((n, s, par), np.int32)
        gmask = np.zeros((n, s, par), bool)
        tmask = np.zeros((n, s - 1), bool)
        amask = np.zeros((n, s - 1), bool)
        for i, b in enumerate(group):
            l = b["grid"].shape[0]
            grid[i, :l] = b["grid"]
            gmask[i, :l] = b["grid_mask"]
            tmask[i, : l - 1] = b["text_loss_mask"]
            amask[i, : l - 1] = b["audio_loss_mask"]
        return {
            "grid": grid, "grid_mask": gmask,
            "text_loss_mask": tmask, "audio_loss_mask": amask,
            "ids": [b["id"] for b in group],
        }
