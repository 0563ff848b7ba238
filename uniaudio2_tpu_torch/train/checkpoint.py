"""Checkpoint save / auto-resume for training (port of
`uniaudio2_tpu/train/checkpoint.py`).

Same layout as the JAX package: per-epoch ``ep{N}.checkpoint/`` directories
holding the train state and a ``meta.json`` with the epoch and the reporter
state; resume picks the newest epoch; inference loads the parameters only.
The tensors go through ``torch.save`` (``tree.pt``) in place of Orbax: one
flat mapping from a path (``params/backbone/layers/qkv_w``,
``opt_state/1/leaves/...``) to a tensor or a number, which loads with
``weights_only=True``. Restoring copies into a state of the same structure
(the caller's freshly initialised state), so nothing is allocated twice on
the card; a tensor of another shape or dtype is refused, not cast. A
checkpoint is written into a temporary directory and renamed into place
once its ``meta.json`` is written, and only directories that hold a
``meta.json`` count, so an interrupted save never breaks the next resume.

Under a mesh (DTensor leaves; the JAX package's Orbax sharded IO) every
rank gathers each leaf whole, rank 0 writes the one full tree and the
others wait at a barrier; a resume copies each rank's chunk of the saved
leaf into its shard, so a mesh run resumes into the same mesh, and
`load_params_for_inference` loads the params into an unsharded tree.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from uniaudio2_tpu_torch.parallel import mesh as meshlib

TREE = "tree.pt"


def _ckpt_dirs(exp_dir: str):
    out = []
    if not os.path.isdir(exp_dir):
        return out
    for name in os.listdir(exp_dir):
        m = re.fullmatch(r"ep(\d+)\.checkpoint", name)
        if m and os.path.isfile(os.path.join(exp_dir, name, "meta.json")):
            out.append((int(m.group(1)), os.path.join(exp_dir, name)))
    return sorted(out)


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(node, prefix: str, out: Dict[str, Any]) -> None:
    kids = _children(node)
    if kids is None:
        if isinstance(node, torch.Tensor):
            node = meshlib.whole(node.detach()).cpu()
        out[prefix] = node
        return
    for key, child in kids:
        _flatten(child, f"{prefix}/{key}" if prefix else str(key), out)


def _restore(node, prefix: str, flat: Dict[str, Any]):
    kids = _children(node)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint has no entry {prefix!r}")
        value = flat[prefix]
        if isinstance(node, torch.Tensor):
            if (tuple(value.shape), value.dtype) != (tuple(node.shape), node.dtype):
                raise ValueError(
                    f"{prefix}: checkpoint {tuple(value.shape)} {value.dtype} "
                    f"!= state {tuple(node.shape)} {node.dtype}")
            with torch.no_grad():
                if meshlib.is_dtensor(node):
                    node.to_local().copy_(meshlib.like(
                        value.to(node.device), node).to_local())
                else:
                    node.copy_(value)
            return node
        return value
    items = [_restore(child, f"{prefix}/{key}" if prefix else str(key), flat)
             for key, child in kids]
    if isinstance(node, dict):
        return dict(zip(node.keys(), items))
    if hasattr(node, "_fields"):
        return type(node)(*items)
    return type(node)(items)


def _tree(state) -> Dict[str, Any]:
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step}


def _multi() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def save_checkpoint(exp_dir: str, epoch: int, state,
                    reporter_state: Optional[Dict] = None) -> str:
    path = os.path.abspath(os.path.join(exp_dir, f"ep{epoch}.checkpoint"))
    flat: Dict[str, Any] = {}
    _flatten(_tree(state), "", flat)      # every rank: the gathers
    if _multi() and dist.get_rank() != 0:
        dist.barrier()
        return path
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, TREE))
    meta = {"epoch": epoch, "reporter": reporter_state or {}}
    with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if _multi():
        dist.barrier()
    return path


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, TREE), map_location="cpu",
                      weights_only=True, mmap=True)


def maybe_resume(exp_dir: str, init_state) -> Tuple[Any, int, Optional[Dict]]:
    """Restore the newest epoch checkpoint if one exists, into
    ``init_state``'s tensors. Returns (state, start_epoch,
    reporter_state)."""
    ckpts = _ckpt_dirs(exp_dir)
    if not ckpts:
        return init_state, 0, None
    epoch, path = ckpts[-1]
    restored = _restore(_tree(init_state), "", _load(path))
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    state = type(init_state)(params=restored["params"],
                             opt_state=restored["opt_state"],
                             step=restored["step"])
    return state, epoch + 1, meta.get("reporter")


def load_params_for_inference(exp_dir: str, like_params) -> Any:
    """Newest checkpoint -> params only, copied into ``like_params``
    (reference `resume_for_inference`, `train_utils.py:159-177`)."""
    ckpts = _ckpt_dirs(exp_dir)
    if not ckpts:
        raise FileNotFoundError(f"no ep*.checkpoint under {exp_dir}")
    return _restore(like_params, "params", _load(ckpts[-1][1]))
