"""Grouped-query attention (port of `uniaudio2_tpu/ops/attention.py`).

The JAX package leaves attention to XLA, so the port writes it as plain
PyTorch contractions: scores in float32 (the operands are upcast, matching
``preferred_element_type=float32``), softmax in float32, probabilities cast
to the value dtype for the second contraction. The group axis is kept, so
KV heads are never repeated.

`decode_attention` also reads int8 caches (`QuantKV`) without
dequantizing them, bounds its reads to a prefix level picked on the host,
and takes the current token's fresh K/V as one extra softmax column
(deferred cache writes). JAX contracts int8 x int8 into int32; torch has
no batched int8 product on CUDA, so the port forms the same integer sums in
float32, where they are exact (every partial sum is an integer below
2^24), and converts them to float32 once, as JAX does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from uniaudio2_tpu_torch.ops.kv_cache import QuantKV

NEG_INF = -1e30


def _group_query_heads(q: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(B, H, T, hd) -> (B, G, H/G, T, hd)."""
    b, h, t, hd = q.shape
    return q.reshape(b, n_groups, h // n_groups, t, hd)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _attend(qg, k, v, mask, scale, logit_softcap):
    scores = torch.einsum("bgpth,bgsh->bgpts", qg.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bgpts,bgsh->bgpth", probs, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    extra_mask: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Full-sequence causal GQA. q (B, H, T, hd); k, v (B, G, T, hd);
    ``extra_mask`` (T, T) or (B, T, T) bool, True = attend; ``window``
    masks keys with q_pos - k_pos >= window. Returns (B, T, H*hd)."""
    b, h, t, hd = q.shape
    g = k.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    if window is not None:
        idx = torch.arange(t, device=q.device)
        causal = causal & (idx[:, None] - idx[None, :] < window)
    if extra_mask is None:
        mask = causal
    elif extra_mask.ndim == 2:
        mask = causal & extra_mask
    else:
        mask = (causal[None] & extra_mask)[:, None, None]
    out = _attend(_group_query_heads(q, g), k, v, mask, scale, logit_softcap)
    return out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: exp(x - max) / sum, a true division
    (the int8 path rounds the probabilities, so an ulp can matter)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _decode_mask(s_max: int, q_positions: torch.Tensor,
                 key_valid: Optional[torch.Tensor], window: Optional[int],
                 exclusive: bool = False) -> torch.Tensor:
    """Position mask (T, S), or (B, 1, 1, T, S) with a per-row
    ``key_valid``. ``exclusive`` masks the query's own slot too (deferred
    writes: the current token is not in the cache yet)."""
    key_idx = torch.arange(s_max, device=q_positions.device)
    if exclusive:
        mask = key_idx[None, :] < q_positions[:, None]
    else:
        mask = key_idx[None, :] <= q_positions[:, None]
    if window is not None:
        mask = mask & (q_positions[:, None] - key_idx[None, :] < window)
    if key_valid is not None:
        mask = (mask[None] & key_valid[:, None, :])[:, None, None]
    return mask


def _self_scores(qg: torch.Tensor, k_fresh: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    """(B, G, P, T, 1) scores of each query step against its own fresh key
    (deferred writes, T == 1)."""
    sc = torch.einsum("bgpth,bgth->bgpt", qg.float(), k_fresh.float()) * scale
    return sc[..., None]


def _with_self(scores, mask, qg, fresh_kv, scale):
    """Append the fresh key's score column and an always-on mask column."""
    k_f = fresh_kv[0].to(qg.dtype)
    scores = torch.cat([scores, _self_scores(qg, k_f, scale)], dim=-1)
    ones = torch.ones(mask.shape[:-1] + (1,), dtype=torch.bool,
                      device=mask.device)
    return scores, torch.cat([mask, ones], dim=-1)


def _attend_prefix(qg, k_cache, v_cache, q_positions, scale, key_valid,
                   logit_softcap, window, fresh_kv=None) -> torch.Tensor:
    """Masked attention of grouped queries (B, G, P, T, hd) against the
    (possibly prefix-sliced) cache; `QuantKV` entries go to
    `_attend_prefix_quant`. With ``fresh_kv`` the cache holds only
    positions < pos and the current token's (B, G, T, hd) K/V add one
    softmax column."""
    if isinstance(k_cache, QuantKV):
        return _attend_prefix_quant(qg, k_cache, v_cache, q_positions, scale,
                                    key_valid, logit_softcap, window, fresh_kv)
    s_max = k_cache.shape[2]
    scores = torch.einsum("bgpth,bgsh->bgpts", qg.float(),
                          k_cache.float()) * scale
    mask = _decode_mask(s_max, q_positions, key_valid, window,
                        exclusive=fresh_kv is not None)
    if fresh_kv is not None:
        scores, mask = _with_self(scores, mask, qg, fresh_kv, scale)
    scores = _softcap(scores, logit_softcap)
    probs = _softmax(torch.where(mask, scores, NEG_INF))
    out = torch.einsum("bgpts,bgsh->bgpth",
                       probs[..., :s_max].to(v_cache.dtype), v_cache)
    if fresh_kv is None:
        return out
    # each query step attends only its own fresh value (T == 1 upstream)
    v_f = fresh_kv[1][:, :, None].to(probs.dtype)
    return out + (probs[..., s_max:] * v_f).to(out.dtype)


# Contractions of int8 values, formed in float32: exact while every partial
# sum stays below 2^24, and then the float32 value JAX gets when it converts
# its int32 sum. Q.K sums hd products of at most 127^2; P.V sums slots, so
# past PV_CHUNK slots it runs in chunks, adds them as int32 and converts
# the sum once, as JAX does.
PV_CHUNK = 1024


def _int_scores(q_i8: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """The int8 Q.K sums (exact), as float32."""
    if 127 * 127 * k_q.shape[-1] >= 2 ** 24:
        raise ValueError(f"head dim {k_q.shape[-1]}: int8 sums not exact in f32")
    return torch.einsum("bgpth,bgsh->bgpts", q_i8.float(), k_q.float())


def _int_values(p_i8: torch.Tensor, v_q: torch.Tensor) -> torch.Tensor:
    """The int8 P.V sums, converted to float32 once."""
    def part(c):
        return torch.einsum("bgpts,bgsh->bgpth",
                            p_i8[..., c:c + PV_CHUNK].float(),
                            v_q[:, :, c:c + PV_CHUNK].float())

    if v_q.shape[2] <= PV_CHUNK:
        return part(0)
    acc = sum(part(c).to(torch.int32)
              for c in range(0, v_q.shape[2], PV_CHUNK))
    return acc.float()


def _attend_prefix_quant(qg, k_cache: QuantKV, v_cache: QuantKV, q_positions,
                         scale, key_valid, logit_softcap, window,
                         fresh_kv=None) -> torch.Tensor:
    """int8-cache attention with nothing dequantized: the per-slot scales
    commute out of both contractions. Q.K: the queries are absmax-quantized
    per row, scores = (q_i8 . k_i8) * q_s * scale * k_s. P.V: the value
    scales fold into the probabilities (p' = softmax * v_s), p' is
    absmax-quantized per row, out = (p'_i8 . v_i8) * p'_s. With
    ``fresh_kv`` the current token's score and value use the exact fresh
    K/V."""
    k_q, k_s = k_cache.q, k_cache.s          # (B,G,S,hd) i8, (B,G,S) f32
    v_q, v_s = v_cache.q, v_cache.s
    s_max = k_q.shape[2]
    qf = qg.float()                           # (B,G,P,T,hd)
    q_s = qf.abs().amax(dim=-1) / 127.0
    q_i8 = torch.round(qf / torch.clamp(q_s, min=1e-30)[..., None])
    q_i8 = torch.clamp(q_i8, -127, 127).to(torch.int8)
    scores = (_int_scores(q_i8, k_q) * (q_s[..., None] * scale)
              * k_s[:, :, None, None, :])
    mask = _decode_mask(s_max, q_positions, key_valid, window,
                        exclusive=fresh_kv is not None)
    if fresh_kv is not None:
        scores, mask = _with_self(scores, mask, qg, fresh_kv, scale)
    scores = _softcap(scores, logit_softcap)
    probs = _softmax(torch.where(mask, scores, NEG_INF))     # f32
    p = probs[..., :s_max] * v_s[:, :, None, None, :]
    p_s = p.amax(dim=-1) / 127.0              # p >= 0
    p_i8 = torch.round(p / torch.clamp(p_s, min=1e-30)[..., None]).to(torch.int8)
    out = _int_values(p_i8, v_q) * p_s[..., None]
    if fresh_kv is not None:
        out = out + probs[..., s_max:] * fresh_kv[1][:, :, None].float()
    return out.to(qg.dtype)


def _slice_prefix(cache, lvl: int):
    """First ``lvl`` slots of a cache entry (tensor or `QuantKV`): views."""
    if isinstance(cache, QuantKV):
        return QuantKV(cache.q[:, :, :lvl], cache.s[:, :, :lvl])
    return cache[:, :, :lvl]


def pick_level(prefix_levels: Sequence[int], filled: int) -> int:
    """The smallest level holding ``filled`` slots (the last level past
    it), as JAX's ``searchsorted`` + clamped ``lax.switch`` pick it."""
    for lvl in prefix_levels:
        if lvl >= filled:
            return lvl
    return prefix_levels[-1]


def decode_attention(
    q: torch.Tensor,
    k_cache,
    v_cache,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    key_valid: Optional[torch.Tensor] = None,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
    prefix_levels: Optional[Tuple[int, ...]] = None,
    fresh_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    filled: Optional[int] = None,
) -> torch.Tensor:
    """Incremental GQA of q (B, H, T, hd) against a static cache
    (B, G, S_max, hd), or `QuantKV` entries, masked by the (T,) int query
    positions (and an optional (B, S_max) ``key_valid``). Without
    ``fresh_kv`` the cache already holds the new K/V; with it, the cache
    holds positions < pos and ``fresh_kv`` = (k, v) (B, G, T, hd) are the
    current token's.

    ``prefix_levels`` (ascending, ending at S_max) bounds the read to the
    smallest level covering the slots the step may attend: the last query
    position + 1, or + 0 with ``fresh_kv``. The level is picked on the
    host: ``filled`` is that slot count as a host int, required with more
    than one level (a position is never read back). Each level is one
    static slice, and the result is the full read's: the masked tail
    contributes exact zeros.
    Returns (B, T, H*hd)."""
    b, h, t, hd = q.shape
    kq = k_cache.q if isinstance(k_cache, QuantKV) else k_cache
    g, s_max = kq.shape[1], kq.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    qg = _group_query_heads(q, g)
    if prefix_levels is not None and len(prefix_levels) > 1:
        if prefix_levels[-1] != s_max or list(prefix_levels) != sorted(
                set(prefix_levels)):
            raise ValueError(
                f"bad prefix levels {prefix_levels} for cache length {s_max}")
        if filled is None:
            raise ValueError("decode_attention: pass filled= (the host's "
                             "slot count); a device position is not read")
        lvl = pick_level(prefix_levels, filled)
        if lvl < s_max:
            k_cache, v_cache = (_slice_prefix(k_cache, lvl),
                                _slice_prefix(v_cache, lvl))
            if key_valid is not None:
                key_valid = key_valid[:, :lvl]
    out = _attend_prefix(qg, k_cache, v_cache, q_positions, scale, key_valid,
                         logit_softcap, window, fresh_kv)
    return out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
