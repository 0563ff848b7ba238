"""Bridge from the JAX package's parameter trees to the port's.

The input is a tree of dicts, lists, ``None`` leaves (the ScalarAE's
absent "pre"/"post" stages), numpy-convertible arrays (bf16 arrays
included) and quantized containers: any object with ``.values``/``.scale``
whose class is named like one of the port's containers. This module does
not import JAX: callers hand it arrays (``np.asarray`` of JAX arrays, or
the JAX tree itself, whose arrays convert through ``np.asarray``).

All seven containers cross, per-channel and grouped. Chunk-major leaves
(the TPU serving layout ``(C, K*, bc)``) are un-chunked to the port's
row-major ``(K*, C*bc)``; all bytes are kept as they are.
`convert_lean_state` carries an `adamw_lean` optimizer state the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from uniaudio2_tpu_torch.ops import quant

_CONTAINERS = {cls.__name__: cls for cls in quant.QUANTIZED}


def to_tensor(a, device="cuda") -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))   # keeps 0-d shapes
    return t.to(device)


def convert_params(tree, device="cuda"):
    """JAX parameter tree -> the port's tree (same keys and nesting; lists
    stay lists and ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: convert_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [convert_params(v, device) for v in tree]
    name = type(tree).__name__
    if name in _CONTAINERS and hasattr(tree, "values"):
        w = _CONTAINERS[name](to_tensor(tree.values, device),
                              to_tensor(tree.scale, device))
        if quant.is_chunk_major(w):
            w = type(w)(quant._unchunk_values(w.values).contiguous(), w.scale)
        return w
    return to_tensor(tree, device)


def convert_lean_state(state, device="cuda"):
    """A JAX ``AdamWLeanState`` (`uniaudio2_tpu/train/lean_opt.py`; its
    ``_LeafState`` / ``_FactoredV`` leaves as arrays) -> the port's
    `train.lean_opt.AdamWLeanState`, same tree and bytes."""
    from uniaudio2_tpu_torch.train import lean_opt

    def leaf(s):
        v = s.v
        if type(v).__name__ == "_FactoredV":
            v = lean_opt._FactoredV(row=to_tensor(v.row, device),
                                    col=to_tensor(v.col, device))
        else:
            v = to_tensor(v, device)
        return lean_opt._LeafState(m_q=to_tensor(s.m_q, device),
                                   m_scale=to_tensor(s.m_scale, device), v=v)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return leaf(tree)

    return lean_opt.AdamWLeanState(count=int(np.asarray(state.count)),
                                   leaves=walk(state.leaves))
