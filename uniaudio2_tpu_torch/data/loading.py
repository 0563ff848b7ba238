"""Training-data loading: the task-dataset JSON DSL (a copy of
`uniaudio2_tpu/data/loading.py`, with the process rank taken from
`torch.distributed` instead of JAX).

Same JSON schema and semantics as the reference loader
(reference `llm_utils/task_definition.py:259-327`): each dataset json
is ``{"task": <format name>, "keys": {data_key: file}, "repeat_num": N}``;
audio keys load ``.pt`` dicts (example_id -> (8, T) codes), text keys load
kaldi-style ``id text...`` files (or ``.pt``); examples missing any key are
dropped; ids are prefixed with the task name; ``repeat_num`` clones examples.

Rank sharding follows `find_data_jsons` (`train_utils.py:296-315`): the glob
expansion must divide the process count and each process takes
``files[rank::world]`` — keyed on the `torch.distributed` rank when a
process group is up, else rank 0 of 1.
"""

from __future__ import annotations

import glob as globlib
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from uniaudio2_tpu_torch.engine.tasks import TASK_FORMATS


def load_pt(path: str) -> Dict[str, np.ndarray]:
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
        for k, v in data.items()
    }


def load_text(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 2:
                logging.warning("empty entry: %r", line.strip())
                continue
            out[parts[0]] = " ".join(parts[1:])
    return out


def load_any(path: str):
    return load_pt(path) if path.endswith(".pt") else load_text(path)


LOADERS = {
    "audio": load_pt,
    "audio_prompt": load_any,
    "text": load_any,
    "hybrid": load_any,
}


def load_task_dataset(
    dataset_json: Dict[str, Any], root_path: Optional[str] = None
) -> Dict[str, Dict[str, Any]]:
    task = dataset_json["task"]
    fmt = TASK_FORMATS[task]
    repeat = int(dataset_json.get("repeat_num", 1))
    examples: Dict[str, Dict[str, Any]] = {}
    for key, tp in zip(fmt["keys"], fmt["type"]):
        if key not in dataset_json["keys"]:
            raise ValueError(f"task {task}: data key {key} missing")
        path = dataset_json["keys"][key]
        if root_path:
            path = os.path.join(root_path, path)
        data = LOADERS[tp](path)
        for eid, value in data.items():
            for rep in range(repeat):
                xid = f"{task}_{eid}" + ("" if rep == 0 else f"_{rep - 1}")
                examples.setdefault(xid, {})[key] = value
    # drop incomplete examples, then tag task + loss keys
    for eid in list(examples):
        if any(k not in examples[eid] for k in fmt["keys"]):
            del examples[eid]
    for eid in examples:
        examples[eid]["task"] = task
        examples[eid]["loss_key"] = list(fmt["loss_key"])
    return examples


def load_all_tasks(
    json_files: Sequence[str], root_path: Optional[str] = None
) -> Tuple[Dict, Dict, Dict]:
    """Returns (data_dict, text_only_dict, audio_prompt_dict) like the
    reference `load_data_for_all_tasks`."""
    data, text, prompt_pool = {}, {}, {}
    for jf in json_files:
        with open(jf, encoding="utf-8") as f:
            dataset_json = json.load(f)
        task_data = load_task_dataset(dataset_json, root_path)
        if dataset_json["task"] == "text_only":
            text.update(task_data)
        else:
            data.update(task_data)
        if dataset_json["task"] in ("PromptTTS", "PromptLTS"):
            prompt_pool.update(task_data)
    return data, text, prompt_pool


def find_data_jsons(
    patterns: Sequence[str],
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> List[str]:
    """Per-process shard of the dataset-json file list."""
    if rank is None or world_size is None:
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if up else 0
        world_size = dist.get_world_size() if up else 1
    out: List[str] = []
    for pattern in patterns:
        pattern = pattern.replace("ALL", "*")
        files = sorted(str(p) for p in Path(
            os.path.dirname(pattern) or "."
        ).glob(os.path.basename(pattern)))
        if not files or len(files) % world_size != 0:
            raise ValueError(
                f"pattern {pattern!r}: {len(files)} files must be a positive "
                f"multiple of world size {world_size}"
            )
        out.extend(files[rank::world_size])
    if not out:
        raise ValueError("no data json files found")
    return out
