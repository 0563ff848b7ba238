"""Static-shape KV cache (port of `uniaudio2_tpu/ops/kv_cache.py`).

``k``/``v`` are ``(n_layer, B, G, S_max, hd)`` stacked buffers or lists of
per-layer ``(B, G, S_max, hd)`` buffers (the serving layout, paired with
unrolled per-layer weights). Unlike the JAX package, writes happen IN PLACE
(`index_copy_` at a device-side position tensor): no copy of the cache per
step and no host synchronisation, so a decode step can later be captured
in a CUDA graph.

Only bf16/f32 entries are ported. The int8 `QuantKV` form and the
coalesced `update_stacked` write are ROADMAP queue 1 item 3.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple, Union

import torch

from uniaudio2_tpu_torch.config import GPTConfig

CacheEntry = Union[torch.Tensor, List[torch.Tensor]]


class KVCache(NamedTuple):
    k: CacheEntry
    v: CacheEntry

    @property
    def max_seq(self) -> int:
        k = self.k[0] if isinstance(self.k, list) else self.k
        return k.shape[-2]


def init_cache(
    cfg: GPTConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    as_lists: bool = False, device: "torch.device | str" = "cuda",
) -> KVCache:
    if dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV cache (QuantKV) is not ported yet: ROADMAP queue 1 item 3")
    if as_lists:
        shape = (batch, cfg.n_query_groups, max_seq, cfg.head_size)
        return KVCache(
            k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(cfg.n_layer)],
            v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(cfg.n_layer)],
        )
    shape = (cfg.n_layer, batch, cfg.n_query_groups, max_seq, cfg.head_size)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def update_layer(
    k_layer: torch.Tensor,
    v_layer: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: "torch.Tensor | int",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``k_new``/``v_new`` (B, G, T, hd) at slots [pos, pos+T) of one
    layer's (B, G, S_max, hd) buffers, in place; returns the buffers.
    ``pos`` is an int or a one-element int64 tensor on the cache's device."""
    t = k_new.shape[2]
    if isinstance(pos, int):
        k_layer[:, :, pos:pos + t] = k_new.to(k_layer.dtype)
        v_layer[:, :, pos:pos + t] = v_new.to(v_layer.dtype)
        return k_layer, v_layer
    idx = pos.reshape(1) + torch.arange(t, device=pos.device)
    k_layer.index_copy_(2, idx, k_new.to(k_layer.dtype))
    v_layer.index_copy_(2, idx, v_new.to(v_layer.dtype))
    return k_layer, v_layer
