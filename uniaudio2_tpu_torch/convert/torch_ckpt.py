"""Checkpoint conversion for the port: reference PyTorch state dicts and
``.npz`` archives -> the port's parameter trees (the counterpart of
`uniaudio2_tpu/convert/torch_to_jax.py`; the port makes no JAX arrays,
hence the other name).

Name maps target the reference's module trees:

* the unified LLM `Model_stage3` (`llm_models/model_new.py:334-355`) over
  litgpt-style GPTs (`lit_model.py:22-60`: ``transformer.wte``,
  ``transformer.h.{i}.{norm_1,attn.qkv,attn.proj,norm_2,mlp.{fc_1,fc_2,
  proj}}``, ``transformer.ln_f``, ``lm_head``), including the legacy fused
  ``attn.attn`` layout (grouped-interleaved), reassembled to the contiguous
  q|k|v layout as `lit_model.py:735-776` does;
* checkpoint envelopes: ``{"model": sd}`` / ``{"state_dict": sd}`` / bare,
  with ``module.`` prefix stripping (`train_utils.py:173-175`), and the
  SQCodec's ``{"codec_model": sd}`` (`reason_tokenizer.py:34-61`), which
  the JAX package's loader leaves closed (it then finds every ScalarAE key
  missing).

Weights transpose from torch ``(out, in)`` to the port's ``(in, out)``;
per-layer tensors stack on a leading layer axis, as in the JAX package.
`convert_unified` returns numpy trees; `to_port` makes them tensors.

``.npz`` archives carry the JAX package's leaf names (the ``/``-joined key
path of each leaf; a list index is ``[i]``, a container field ``.name``),
so a file written by either package loads into the other. A bf16 leaf is
stored as 2-byte void (``|V2``), the form ``np.savez`` gives JAX's bf16
arrays; the port reads such a leaf back as bf16 wherever the model's leaf
is bf16 (the JAX package cannot load it back).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.config import GPTConfig, UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import to_tensor


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """torch.load a checkpoint file and normalise to {name: float32 ndarray}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        sd = ckpt["model"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and isinstance(ckpt.get("codec_model"), dict):
        sd = ckpt["codec_model"]    # the SQCodec envelope
    else:
        sd = ckpt
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if hasattr(v, "detach"):
            v = v.detach().float().numpy()
        out[k] = np.asarray(v)
    return out


def qkv_reassemble(w: np.ndarray, cfg: GPTConfig) -> np.ndarray:
    """Legacy litgpt fused-qkv layout (per-group interleaved
    [q_0..q_{qpk-1}, k, v] blocks) -> contiguous [Q | K | V]
    (the inverse of the reference's `lit_model.py:735-776`)."""
    hs, g, qpk = cfg.head_size, cfg.n_query_groups, cfg.q_per_kv
    blocks = w.reshape(g, (qpk + 2) * hs, -1)
    q = blocks[:, : qpk * hs].reshape(g * qpk * hs, -1)
    k = blocks[:, qpk * hs : (qpk + 1) * hs].reshape(g * hs, -1)
    v = blocks[:, (qpk + 1) * hs :].reshape(g * hs, -1)
    return np.concatenate([q, k, v], axis=0)


def convert_gpt(
    sd: Mapping[str, np.ndarray], prefix: str, cfg: GPTConfig
) -> Tuple[Dict[str, Any], List[str]]:
    """litgpt GPT subtree -> our stacked-layer params. Returns
    (params, missing_keys)."""
    missing: List[str] = []

    def get(name):
        key = prefix + name
        if key not in sd:
            missing.append(key)
            return None
        return sd[key]

    n_l = cfg.n_layer
    qkv, attn_proj, n1, n2, fc1, fc2, mproj = [], [], [], [], [], [], []
    for i in range(n_l):
        base = f"transformer.h.{i}."
        w = get(base + "attn.qkv.weight")
        if w is None and (prefix + base + "attn.attn.weight") in sd:
            missing.pop()
            w = qkv_reassemble(sd[prefix + base + "attn.attn.weight"], cfg)
        qkv.append(w.T if w is not None else np.zeros(
            (cfg.n_embd, (cfg.n_head + 2 * cfg.n_query_groups) * cfg.head_size),
            np.float32))
        for lst, name, tr in (
            (attn_proj, base + "attn.proj.weight", True),
            (n1, base + "norm_1.weight", False),
            (n2, base + "norm_2.weight", False),
            (fc1, base + "mlp.fc_1.weight", True),
            (fc2, base + "mlp.fc_2.weight", True),
            (mproj, base + "mlp.proj.weight", True),
        ):
            w = get(name)
            if w is None:
                w = np.zeros((1,), np.float32)
            lst.append(w.T if tr and w.ndim == 2 else w)

    params: Dict[str, Any] = {
        "layers": {
            "norm1_w": np.stack(n1),
            "qkv_w": np.stack(qkv),
            "attn_proj_w": np.stack(attn_proj),
            "norm2_w": np.stack(n2),
            "fc1_w": np.stack(fc1),
            "fc2_w": np.stack(fc2),
            "mlp_proj_w": np.stack(mproj),
        },
        "ln_f_w": get("transformer.ln_f.weight"),
    }
    if cfg.has_wte:
        params["wte"] = get("transformer.wte.weight")
    if cfg.has_lm_head:
        w = get("lm_head.weight")
        params["lm_head_w"] = w.T if w is not None else None
    return params, missing


def convert_unified(
    sd: Mapping[str, np.ndarray], cfg: UnifiedModelConfig
) -> Tuple[Dict[str, Any], List[str]]:
    """Reference `Model_stage3` state dict -> unified-model params."""
    missing: List[str] = []
    backbone, m = convert_gpt(sd, "backbone.", cfg.backbone)
    missing += m
    decoder, m = convert_gpt(sd, "decoder.", cfg.decoder)
    missing += m
    und, m = convert_gpt(sd, "audio_understanding_expert.", cfg.understanding_expert)
    missing += m
    gen, m = convert_gpt(sd, "audio_generation_expert.", cfg.generation_expert)
    missing += m

    def get(name):
        if name not in sd:
            missing.append(name)
            return None
        return sd[name]

    proj = get("projection.weight")
    params = {
        "backbone": backbone,
        "decoder": decoder,
        "understanding_expert": und,
        "generation_expert": gen,
        "audio_embeddings": get("audio_embeddings.weight"),
        "projection_w": proj.T if proj is not None else None,
        "audio_head": get("audio_head"),
    }
    return params, missing


def _map(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(name, leaf)`` over the leaves of a tree of dicts, lists, named
    tuples (the quantized containers) and ``None``, ``name`` in the JAX
    package's ``save_npz`` naming."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def to_port(params, dtype=None, device="cuda"):
    """numpy (or CPU tensor) tree -> the port's tensors on ``device``, the
    floating leaves cast to ``dtype`` (the JAX package's ``to_jax``)."""

    def conv(_, x):
        t = x if isinstance(x, torch.Tensor) else to_tensor(x, "cpu")
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return _map(conv, params)


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def save_npz(path: str, params) -> None:
    """Flatten a tree to an ``.npz`` archive under the JAX leaf names."""
    arrays: Dict[str, np.ndarray] = {}
    _map(lambda name, v: arrays.__setitem__(name, _to_numpy(v)), params)
    np.savez(path, **arrays)


def load_npz(path: str, like) -> Any:
    """Load an ``.npz`` archive into the structure of ``like`` (a tree of
    tensors on any device, "meta" included): CPU tensors, each as the file
    stores it, but a ``|V2`` leaf read as bf16 where ``like``'s is bf16."""

    def leaf(name, v):
        arr = np.asarray(data[name])
        if arr.shape != tuple(v.shape):
            raise ValueError(
                f"checkpoint leaf {name!r} has shape {arr.shape}, model "
                f"expects {tuple(v.shape)}: config/checkpoint mismatch")
        if arr.dtype.kind == "V":
            if arr.dtype.itemsize != 2 or v.dtype != torch.bfloat16:
                raise ValueError(f"checkpoint leaf {name!r} holds {arr.dtype} "
                                 f"where the model has {v.dtype}")
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(arr, order="C"))

    with np.load(path) as data:
        return _map(leaf, like)
