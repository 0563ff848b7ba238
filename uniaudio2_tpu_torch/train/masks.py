"""Attention-mask builders for training (port of
`uniaudio2_tpu/train/masks.py`).

``prefix_lm_mask`` has the reference's `attention_mask` semantics
(reference `llm_utils/train_utils.py:246-286`): given a per-step loss
mask holding one contiguous True segment per row,

1. target steps are causal and see the whole prefix;
2. prefix steps see each other bidirectionally when ``prefix_lm`` is on,
   otherwise causally;
3. padding (after the target segment) neither sees nor is seen.

``validate_loss_mask`` is the host-side check of the one-segment invariant.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1 << 30


def prefix_lm_mask(loss_mask: torch.Tensor, prefix_lm: bool = True) -> torch.Tensor:
    """(B, S) bool loss mask -> (B, S, S) bool attention mask (True=attend)."""
    b, s = loss_mask.shape
    axis = torch.arange(s, dtype=torch.int32, device=loss_mask.device)
    start = torch.where(loss_mask, axis[None, :], _BIG).amin(dim=1)      # (B,)
    end = torch.where(loss_mask, axis[None, :], -_BIG).amax(dim=1)       # (B,)
    mask = (axis[:, None] >= axis[None, :]).expand(b, s, s)
    if prefix_lm:
        mask = mask | (axis[None, None, :] < start[:, None, None])
    return mask & ~(axis[None, None, :] > end[:, None, None])


def validate_loss_mask(loss_mask: np.ndarray) -> None:
    """Host-side check of the one-contiguous-True-segment invariant the
    reference asserts in-graph (`train_utils.py:271-273`)."""
    loss_mask = np.asarray(loss_mask, bool)
    for row in loss_mask:
        idx = np.flatnonzero(row)
        if idx.size == 0:
            raise ValueError("loss mask row has no True entries")
        if idx[-1] - idx[0] + 1 != idx.size:
            raise ValueError("loss mask row is not one contiguous segment")
