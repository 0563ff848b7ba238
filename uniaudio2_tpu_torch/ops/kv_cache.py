"""Static-shape KV cache (port of `uniaudio2_tpu/ops/kv_cache.py`).

``k``/``v`` are ``(n_layer, B, G, S_max, hd)`` stacked buffers or lists of
per-layer ``(B, G, S_max, hd)`` buffers (the serving layout, paired with
unrolled per-layer weights). Either form may be a `QuantKV`: int8 values
plus one f32 absmax scale per (batch, group, slot), quantized at write.
Unlike the JAX package, writes happen IN PLACE (`index_copy_` at a
device-side position tensor, or a slice at a host int): no copy of the
cache per step and no host synchronisation, so a decode step can later be
captured in a CUDA graph. `layer_entry` and `unstack_cache` return views,
so a write through a layer's entry lands in the stacked buffer.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple, Union

import torch

from uniaudio2_tpu_torch.config import GPTConfig


class QuantKV(NamedTuple):
    """One int8-quantized cache tensor: ``q`` int8 values in the layout of
    the bf16 cache ((..., B, G, S, hd)) and ``s`` f32 per-slot absmax
    scales ((..., B, G, S)); the value is ``q * s[..., None]``."""

    q: torch.Tensor
    s: torch.Tensor


CacheEntry = Union[torch.Tensor, QuantKV]


class KVCache(NamedTuple):
    k: "CacheEntry | List[CacheEntry]"
    v: "CacheEntry | List[CacheEntry]"

    @property
    def max_seq(self) -> int:
        k = self.k[0] if isinstance(self.k, list) else self.k
        if isinstance(k, QuantKV):
            k = k.q
        return k.shape[-2]


def _zeros_entry(shape, dtype, device) -> CacheEntry:
    if dtype == torch.int8:
        return QuantKV(q=torch.zeros(shape, dtype=torch.int8, device=device),
                       s=torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(
    cfg: GPTConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    as_lists: bool = False, device: "torch.device | str" = "cuda",
    n_groups: "int | None" = None,
) -> KVCache:
    """``dtype=torch.int8`` builds the quantized cache (`QuantKV` entries);
    ``n_groups`` (default all of the config's) is the kv groups it holds."""
    g = cfg.n_query_groups if n_groups is None else n_groups
    if as_lists:
        shape = (batch, g, max_seq, cfg.head_size)
        return KVCache(
            k=[_zeros_entry(shape, dtype, device) for _ in range(cfg.n_layer)],
            v=[_zeros_entry(shape, dtype, device) for _ in range(cfg.n_layer)])
    shape = (cfg.n_layer, batch, g, max_seq, cfg.head_size)
    return KVCache(k=_zeros_entry(shape, dtype, device),
                   v=_zeros_entry(shape, dtype, device))


def layer_entry(stacked: "CacheEntry | List[CacheEntry]", i: int
                ) -> CacheEntry:
    """Layer ``i`` of a cache field: a list's item, or a view of a stacked
    (L, ...) entry."""
    if isinstance(stacked, list):
        return stacked[i]
    if isinstance(stacked, QuantKV):
        return QuantKV(stacked.q[i], stacked.s[i])
    return stacked[i]


def set_layer_entry(stacked: CacheEntry, i: int, val: CacheEntry) -> CacheEntry:
    """Write one layer back into a stacked cache entry, in place (a no-op
    for a view that `layer_entry` gave)."""
    if isinstance(stacked, QuantKV):
        if val.q.data_ptr() != stacked.q[i].data_ptr():
            stacked.q[i] = val.q
            stacked.s[i] = val.s
    elif val.data_ptr() != stacked[i].data_ptr():
        stacked[i] = val
    return stacked


def unstack_cache(cache: KVCache) -> KVCache:
    """Stacked (L, B, G, S, hd) -> per-layer views (no-op if already
    lists)."""
    if isinstance(cache.k, list):
        return cache
    n = (cache.k.q if isinstance(cache.k, QuantKV) else cache.k).shape[0]
    return KVCache(k=[layer_entry(cache.k, i) for i in range(n)],
                   v=[layer_entry(cache.v, i) for i in range(n)])


def quantize_slots(x: torch.Tensor) -> QuantKV:
    """(..., T, hd) values -> int8 with one absmax scale per (..., T) slot.
    The same f32 operations as JAX (division, not a reciprocal product;
    `torch.round` rounds half to even like `jnp.round`), so the same
    bytes."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(s, min=1e-30)[..., None])
    return QuantKV(q=torch.clamp(q, -127, 127).to(torch.int8), s=s)


def _slots(pos: "torch.Tensor | int", t: int):
    """Slots [pos, pos+t): a slice for a host int, an index tensor for a
    one-element device position."""
    if isinstance(pos, int):
        return slice(pos, pos + t)
    return pos.reshape(1) + torch.arange(t, device=pos.device)


def _write(buf: torch.Tensor, dim: int, slots, new: torch.Tensor) -> None:
    if isinstance(slots, slice):
        buf[(slice(None),) * dim + (slots,)] = new
    else:
        buf.index_copy_(dim, slots, new)


def _update_entry(entry: CacheEntry, new: torch.Tensor, pos, slot_dim: int
                  ) -> CacheEntry:
    slots = _slots(pos, new.shape[slot_dim])
    if isinstance(entry, QuantKV):
        qn = quantize_slots(new)
        _write(entry.q, slot_dim, slots, qn.q)
        _write(entry.s, slot_dim, slots, qn.s)
    else:
        _write(entry, slot_dim, slots, new.to(entry.dtype))
    return entry


def update_layer(
    k_layer: CacheEntry,
    v_layer: CacheEntry,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: "torch.Tensor | int",
) -> Tuple[CacheEntry, CacheEntry]:
    """Write ``k_new``/``v_new`` (B, G, T, hd) at slots [pos, pos+T) of one
    layer's (B, G, S_max, hd) entries, in place (quantizing at write for a
    `QuantKV`); returns the entries. ``pos`` is an int or a one-element
    int64 tensor on the cache's device."""
    return (_update_entry(k_layer, k_new, pos, 2),
            _update_entry(v_layer, v_new, pos, 2))


def update_stacked(
    k_all: CacheEntry,
    v_all: CacheEntry,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: "torch.Tensor | int",
) -> Tuple[CacheEntry, CacheEntry]:
    """The coalesced deferred write: ``k_new``/``v_new`` (L, B, G, T, hd),
    one frame's fresh K/V for every layer, written at slots [pos, pos+T) of
    the stacked (L, B, G, S_max, hd) cache with one write per field (2 for
    a bf16 cache, 4 for a `QuantKV`, all layers quantized in one op),
    in place."""
    return (_update_entry(k_all, k_new, pos, 3),
            _update_entry(v_all, v_new, pos, 3))


def reorder(caches, order: torch.Tensor):
    """Gather the batch rows of every cache tensor in ``caches`` (a
    `KVCache`, a tuple of them such as `UnifiedCaches`, a list or one
    entry) by ``order`` (B,) int64: row b becomes old row ``order[b]``.
    The counterpart of the JAX engine's ``reorder_fn``
    (`uniaudio2_tpu/engine/decode.py:876-891`) for beam search. The batch
    axis is ``ndim - 4`` of values (stacked (L, B, G, S, hd) or per-layer
    (B, G, S, hd)) and ``ndim - 3`` of `QuantKV` scales. Unlike JAX, which
    returns new arrays, the gathered rows are written back into the same
    buffers (the caches stay where their views point); returns
    ``caches``."""
    if isinstance(caches, QuantKV):
        for t, dim in ((caches.q, caches.q.ndim - 4),
                       (caches.s, caches.s.ndim - 3)):
            t.copy_(t.index_select(dim, order))
    elif isinstance(caches, torch.Tensor):
        caches.copy_(caches.index_select(caches.ndim - 4, order))
    else:                          # KVCache, UnifiedCaches, list of entries
        for c in caches:
            reorder(c, order)
    return caches
