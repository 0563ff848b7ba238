"""Decoder-only transformer, Llama-3.2 family (port of
`uniaudio2_tpu/models/gpt.py`).

Same math and parameter tree as the JAX package: GQA attention with fused
QKV, full-rotary Llama-3 RoPE, RMSNorm, SwiGLU, non-parallel residual;
every per-layer leaf stacked on a leading ``n_layer`` axis, or a list of
per-layer dicts in the unrolled serving layout (`unstack_layers`). Weights
are ``(in_features, out_features)``.

The quantized decode step dispatches to the port's kernels exactly where
the JAX package dispatches to Pallas: `_qkv` -> `qkv_step.qkv_rope_step`,
`_mlp` / `_mlp_block` -> `fused_mlp.fused_swiglu`, every other quantized
product -> `quant.matmul` (the int4 / int8 GEMV kernels).

`forward` is also the training forward: ``remat`` checkpoints the first k
layers (``torch.utils.checkpoint``, non-reentrant), and the per-layer views
of the stacked leaves come from one ``unbind``, so each stacked leaf gets
its gradient from one stack in the backward pass.

`decode_step` takes the JAX engine's cache policies: an int8 `QuantKV`
cache, prefix-bounded attention reads (``attn_block``; the level is picked
from a host position, never read back from the device) and deferred KV
writes (one coalesced write of every layer's K/V per step, stacked cache).

MoE layers (``cfg.n_expert``): the JAX package's dense combine, every
expert on every token with the routing weights zeroing the others, over
expert stacks (L, E, in, out) (plain einsums, as in JAX: no Pallas kernel
there). Serving keeps the expert stacks in float (the quantizers take
3-D leaves only, as in JAX).

Tensor parallelism (``tp``, a `parallel.mesh.TensorParallel`): each rank
of the tp group attends with its share of the heads and kv groups. In
`forward` (training) the MLP is split too, Megatron style: qkv / fc1 /
fc2 by columns (or the experts), the projections by rows, each sliced
before its product, the partial sums all-reduced; a mesh's DTensor
leaves are gathered a layer at a time. In `prefill` / `decode_step` (serving) the cache holds the
rank's kv groups and the heads' outputs are gathered before the output
projection, whose kernel takes its operands whole.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from uniaudio2_tpu_torch.config import GPTConfig
from uniaudio2_tpu_torch.ops import fused_mlp, qkv_step
from uniaudio2_tpu_torch.ops.attention import causal_attention, decode_attention
from uniaudio2_tpu_torch.ops.kv_cache import (
    KVCache, layer_entry, update_layer, update_stacked,
)
from uniaudio2_tpu_torch.ops.norms import rms_norm
from uniaudio2_tpu_torch.ops.quant import matmul
from uniaudio2_tpu_torch.ops.rope import apply_rope, rope_cache
from uniaudio2_tpu_torch.parallel import mesh as meshlib

Params = Dict[str, Any]

# the leaves whose gradient each rank of a tensor-parallel layer computes
# a share of (its heads, hidden units or experts; the router's from its
# experts' outputs)
TP_SPLIT = ("qkv_w", "attn_proj_w", "fc1_w", "fc2_w", "mlp_proj_w",
            "moe_gate_w")


def tp_for(cfg: GPTConfig, tp):
    """``tp`` when the config's heads, kv groups and MLP hidden units (or
    experts) split evenly over it, else None (the stack runs whole)."""
    if tp is None:
        return None
    mlp = cfg.n_expert if cfg.n_expert else cfg.intermediate_size
    return tp if tp.divides(cfg.n_head, cfg.n_query_groups, mlp) else None


def init_params(cfg: GPTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Random init of the reference's scheme: normal(0, 0.02) for linears
    and embeddings, ones for RMSNorm weights. MoE configs stack their
    experts on axis 1 (expert parallelism is a dim-1 sharding)."""
    n_l, d = cfg.n_layer, cfg.n_embd
    hd, h, g = cfg.head_size, cfg.n_head, cfg.n_query_groups
    i = cfg.intermediate_size

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    layers: Params = {
        "norm1_w": torch.ones((n_l, d), dtype=dtype, device=device),
        "qkv_w": normal(n_l, d, (h + 2 * g) * hd),
        "attn_proj_w": normal(n_l, h * hd, d),
        "norm2_w": torch.ones((n_l, d), dtype=dtype, device=device),
    }
    if cfg.n_expert:
        e, mi = cfg.n_expert, cfg.moe_intermediate_size
        layers["moe_gate_w"] = normal(n_l, d, e)
        layers["fc1_w"] = normal(n_l, e, d, mi)
        layers["fc2_w"] = normal(n_l, e, d, mi)
        layers["mlp_proj_w"] = normal(n_l, e, mi, d)
    else:
        layers["fc1_w"] = normal(n_l, d, i)
        layers["fc2_w"] = normal(n_l, d, i)
        layers["mlp_proj_w"] = normal(n_l, i, d)
    params: Params = {"layers": layers,
                      "ln_f_w": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.has_wte:
        params["wte"] = normal(cfg.padded_vocab_size, d)
    if cfg.has_lm_head:
        params["lm_head_w"] = normal(d, cfg.padded_vocab_size)
    return params


def param_count(params: Params) -> int:
    """Number of parameters in a tree of tensors."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return 0 if params is None else params.numel()


def index_leaf(w, i: int):
    """Layer ``i`` of a stacked leaf (tensor or quantized container)."""
    if isinstance(w, tuple):
        return type(w)(*(t[i] for t in w))
    return w[i]


def _unbind(w):
    """Per-layer views of a stacked leaf (tensor or quantized container)."""
    if isinstance(w, tuple):
        return [type(w)(*parts) for parts in zip(*(t.unbind(0) for t in w))]
    return w.unbind(0)


def unstack_layers(params: Params) -> Params:
    """Stacked layer leaves -> a list of per-layer dicts (views, no copy)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params
    views = {k: _unbind(v) for k, v in layers.items()}
    n_layer = len(next(iter(views.values())))
    out = dict(params)
    out["layers"] = [{k: v[i] for k, v in views.items()} for i in range(n_layer)]
    return out


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int -> (B, S, D)."""
    return params["wte"][tokens]


def lm_head(params: Params, h: torch.Tensor,
            cfg: Optional[GPTConfig] = None) -> torch.Tensor:
    """(..., D) -> (..., padded_vocab) f32 logits (softcapped if set)."""
    logits = matmul(h, params["lm_head_w"], out_dtype=torch.float32)
    if cfg is not None and cfg.final_logit_softcapping is not None:
        cap = cfg.final_logit_softcapping
        logits = torch.tanh(logits / cap) * cap
    return logits


def _qkv(layer: Params, cfg: GPTConfig, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor, pre_norm=None, tp=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + split + head-reshape + RoPE -> q (B,H,T,hd), k/v (B,G,T,hd).
    Quantized single-token steps with a folded norm take the fused QKV
    kernel. With ``tp`` the weight holds this rank's columns (`_tp_qkv_w`)
    and H, G are its heads and kv groups."""
    b, t, _ = x.shape
    h, g, hd = cfg.n_head, cfg.n_query_groups, cfg.head_size
    if tp is not None:
        h, g = h // tp.size, g // tp.size
    if pre_norm is not None and t == 1 and cfg.rope_n_elem == hd:
        x1 = x[:, 0].contiguous()
        if qkv_step.can_fuse(layer["qkv_w"], x1, h, g, hd):
            q2, k2, v2 = qkv_step.qkv_rope_step(
                x1, layer["qkv_w"], pre_norm[0], pre_norm[1], cos[0], sin[0],
                h, g, hd)
            return (q2.reshape(b, h, 1, hd), k2.reshape(b, g, 1, hd),
                    v2.reshape(b, g, 1, hd))
    qkv = matmul(x, layer["qkv_w"], pre_norm=pre_norm)
    q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
    q = q.reshape(b, t, h, hd).transpose(1, 2)
    k = k.reshape(b, t, g, hd).transpose(1, 2)
    v = v.reshape(b, t, g, hd).transpose(1, 2)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(layer: Params, x: torch.Tensor, cfg: GPTConfig, tp=None
         ) -> torch.Tensor:
    """SwiGLU or MoE; quantized small-M steps take the fused kernel. With
    ``tp`` this rank computes its share of the hidden units (or experts)
    and the partial sums are all-reduced."""
    if tp is not None:
        x = tp.copy_in(x)
    if "moe_gate_w" in layer:
        out = _moe_mlp(layer, x, cfg, tp)
    else:
        w1, w2, w3 = layer["fc1_w"], layer["fc2_w"], layer["mlp_proj_w"]
        if tp is None and fused_mlp.can_fuse(w1, w2, w3, x):
            return fused_mlp.fused_swiglu(x, w1, w2, w3)
        if tp is not None:
            part = tp.part(w1.shape[-1])
            w1, w2, w3 = w1[:, part], w2[:, part], w3[part]
        gate = matmul(x, w1)
        up = matmul(x, w2)
        h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
        out = matmul(h, w3)
    return out if tp is None else tp.reduce(out)


def _mlp_block(layer: Params, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """``x + mlp(rmsnorm(x))``: one fused kernel on the quantized decode
    path, the composed form elsewhere."""
    if "moe_gate_w" not in layer:
        w1, w2, w3 = layer["fc1_w"], layer["fc2_w"], layer["mlp_proj_w"]
        if fused_mlp.can_fuse(w1, w2, w3, x):
            return fused_mlp.fused_swiglu(
                x, w1, w2, w3, norm_w=layer["norm2_w"],
                norm_eps=cfg.norm_eps, residual=x)
    hn = rms_norm(x, layer["norm2_w"], cfg.norm_eps)
    return x + _mlp(layer, hn, cfg)


def _moe_mlp(layer: Params, x: torch.Tensor, cfg: GPTConfig, tp=None
             ) -> torch.Tensor:
    """Mixtral-style top-k routed SwiGLU experts (reference `LLaMAMoE`) as
    a dense combine: every expert runs on every token and the routing
    weights zero out the experts not selected (static shapes, one einsum
    per projection over the expert stack). With ``tp`` this rank runs its
    share of the experts (partial sum; the caller reduces)."""
    router = torch.einsum("...d,de->...e", x,
                          layer["moe_gate_w"].to(x.dtype))
    probs, idx = torch.topk(router, cfg.n_expert_per_token)
    probs = torch.softmax(probs.float(), dim=-1).to(x.dtype)
    gates = (torch.nn.functional.one_hot(idx, cfg.n_expert).to(x.dtype)
             * probs[..., None]).sum(dim=-2)                    # (..., E)
    w1, w2, w3 = layer["fc1_w"], layer["fc2_w"], layer["mlp_proj_w"]
    if tp is not None:
        part = tp.part(cfg.n_expert)
        w1, w2, w3, gates = w1[part], w2[part], w3[part], gates[..., part]
    xw = x.to(w1.dtype)
    g1 = torch.einsum("...d,edi->...ei", xw, w1)
    g2 = torch.einsum("...d,edi->...ei", xw, w2)
    h = torch.nn.functional.silu(g1) * g2 * gates[..., None]
    return torch.einsum("...ei,eid->...d", h, w3).to(x.dtype)


def _layer_windows(cfg: GPTConfig, n_layers: int):
    """Per-layer sliding window (None = full causal)."""
    if cfg.sliding_window_size is None:
        return [None] * n_layers
    return [cfg.sliding_window_size if f else None
            for f in cfg.sliding_window_indices]


@functools.lru_cache(maxsize=64)
def _rope_tables(cfg: GPTConfig, max_positions: int, device: torch.device):
    return rope_cache(max_positions, cfg.rope_n_elem, base=cfg.rope_base,
                      adjustments=cfg.rope_adjustments, device=device)


def _layers(params: Params):
    return unstack_layers(params)["layers"]


def forward(params: Params, cfg: GPTConfig, x: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            extra_mask: Optional[torch.Tensor] = None,
            remat: "bool | int" = False, tp=None) -> torch.Tensor:
    """Full-sequence forward over continuous features (B, S, D) -> hidden
    states after the final norm (B, S, D).

    ``remat`` checkpoints each layer: backward keeps the per-layer inputs
    and recomputes one layer's internals at a time. An int checkpoints the
    first k layers only (selective remat); True is all, False or 0 none.
    ``tp``: tensor parallel over heads and the MLP (`tp_for`). DTensor
    layer leaves (a mesh's train step) are gathered a layer at a time
    (`_gather_layer`)."""
    tp = tp_for(cfg, tp)
    h, hd = cfg.n_head, cfg.head_size
    b, s, d = x.shape
    cos_t, sin_t = _rope_tables(
        cfg, s if positions is None else min(cfg.block_size, 8192), x.device)
    if positions is None:
        cos, sin = cos_t[:s], sin_t[:s]
    else:
        cos, sin = cos_t[positions], sin_t[positions]
    scale = 1.0 / math.sqrt(cfg.attention_scores_scalar or cfg.head_size)

    def layer_fn(xc, layer, win):
        layer = _gather_layer(layer, tp)
        hn = rms_norm(xc, layer["norm1_w"], cfg.norm_eps)
        if tp is not None:
            hn = tp.copy_in(hn)
            layer = dict(layer, qkv_w=_tp_qkv_w(layer["qkv_w"], cfg, tp),
                         attn_proj_w=layer["attn_proj_w"][tp.part(h * hd)])
        q, k, v = _qkv(layer, cfg, hn, cos, sin, tp=tp)
        attn = causal_attention(q, k, v, scale=scale, extra_mask=extra_mask,
                                logit_softcap=cfg.attention_logit_softcapping,
                                window=win)
        out = matmul(attn, layer["attn_proj_w"])
        xc = xc + (out if tp is None else tp.reduce(out))
        hn = rms_norm(xc, layer["norm2_w"], cfg.norm_eps)
        return xc + _mlp(layer, hn, cfg, tp)

    layers = _layers(params)
    n = len(layers)
    k = n if remat is True else 0 if remat is False else max(0, min(int(remat), n))
    for i, (layer, win) in enumerate(zip(layers, _layer_windows(cfg, n))):
        if i < k:
            x = checkpoint(layer_fn, x, layer, win, use_reentrant=False)
        else:
            x = layer_fn(x, layer, win)
    return rms_norm(x, params["ln_f_w"], cfg.norm_eps)


def _gather_layer(layer: Params, tp) -> Params:
    """One layer's leaves whole, gathered as the layer runs (FSDP's gather
    on use; a remat layer gathers again in its backward, so under remat
    one layer's leaves at a time are held whole). A DTensor leaf's
    gradient comes back reduce-scattered over the data-parallel dimensions
    and summed over tp for the leaves each tp rank computes a share of
    (`TP_SPLIT`). Plain tensors pass as they are."""
    return {k: meshlib.gather(w, tp_partial=tp is not None and k in TP_SPLIT)
            for k, w in layer.items()}


def _tp_qkv_w(w: torch.Tensor, cfg: GPTConfig, tp) -> torch.Tensor:
    """This rank's columns of a whole qkv weight: its heads' q, then its kv
    groups' k and v (the product then computes only its share)."""
    h, g, hd = cfg.n_head, cfg.n_query_groups, cfg.head_size
    q, k, v = torch.split(w, [h * hd, g * hd, g * hd], dim=-1)
    return torch.cat([q[..., tp.part(h * hd)], k[..., tp.part(g * hd)],
                      v[..., tp.part(g * hd)]], dim=-1)


def _tp_heads(tp, cfg: GPTConfig, q, k, v):
    """This rank's heads and kv groups of a whole QKV projection."""
    if tp is None:
        return q, k, v
    return (q[:, tp.part(cfg.n_head)], k[:, tp.part(cfg.n_query_groups)],
            v[:, tp.part(cfg.n_query_groups)])


def _tp_out(tp, attn: torch.Tensor) -> torch.Tensor:
    """Every rank's heads' attention outputs, in head order."""
    return attn if tp is None else tp.gather(attn, dim=-1)


def prefill(params: Params, cfg: GPTConfig, x: torch.Tensor, cache: KVCache,
            *, extra_mask: Optional[torch.Tensor] = None, tp=None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run a (padded) prompt block at positions [0, S), writing K/V into
    the cache in place. Returns (final-normed hidden states, cache). With
    ``tp`` (`tp_for`) the cache holds this rank's kv groups."""
    tp = tp_for(cfg, tp)
    b, s, d = x.shape
    cos_t, sin_t = _rope_tables(cfg, cache.max_seq, x.device)
    cos, sin = cos_t[:s], sin_t[:s]
    scale = 1.0 / math.sqrt(cfg.attention_scores_scalar or cfg.head_size)
    layers = _layers(params)
    for i, (layer, win) in enumerate(
            zip(layers, _layer_windows(cfg, len(layers)))):
        hn = rms_norm(x, layer["norm1_w"], cfg.norm_eps)
        q, k, v = _tp_heads(tp, cfg, *_qkv(layer, cfg, hn, cos, sin))
        # a list item, or a view into the stacked buffer: written in place
        # (quantized at write for an int8 cache; attention reads the fresh K/V)
        update_layer(layer_entry(cache.k, i), layer_entry(cache.v, i), k, v,
                     0)
        attn = causal_attention(q, k, v, scale=scale, extra_mask=extra_mask,
                                logit_softcap=cfg.attention_logit_softcapping,
                                window=win)
        x = x + matmul(_tp_out(tp, attn), layer["attn_proj_w"])
        hn = rms_norm(x, layer["norm2_w"], cfg.norm_eps)
        x = x + _mlp(layer, hn, cfg)
    return rms_norm(x, params["ln_f_w"], cfg.norm_eps), cache


def _prefix_levels(s_max: int, block: Optional[int]
                   ) -> Optional[Tuple[int, ...]]:
    """Static attention-read levels [block, 2*block, ..., s_max]; None when
    bounding is off or cannot help (block >= s_max)."""
    if not block or block >= s_max:
        return None
    return tuple(range(block, s_max, block)) + (s_max,)


def decode_step(params: Params, cfg: GPTConfig, x: torch.Tensor,
                cache: KVCache, pos: "torch.Tensor | int", *,
                key_valid: Optional[torch.Tensor] = None,
                attn_block: Optional[int] = None,
                kv_write: str = "inline",
                host_pos: Optional[int] = None,
                tp=None) -> Tuple[torch.Tensor, KVCache]:
    """One incremental step of ``x`` (B, T, D) at positions [pos, pos+T),
    updating the cache in place. ``pos`` is an int or a one-element int64
    device tensor (no host synchronisation either way).

    ``attn_block`` bounds attention reads to the smallest multiple of the
    block covering the filled cache (`decode_attention(prefix_levels=)`);
    the level is picked from ``host_pos``, the position as a host int (an
    int ``pos`` is its own). ``kv_write="deferred"`` (T == 1, stacked cache
    only) attends over the cache prefix [0, pos) plus the fresh K/V as one
    extra softmax column and writes every layer's K/V at the end in one
    `update_stacked`; "inline" writes each layer's slot before it
    attends. With ``tp`` (`tp_for`) the cache holds this rank's kv
    groups."""
    tp = tp_for(cfg, tp)
    b, t, d = x.shape
    deferred = kv_write == "deferred"
    if kv_write not in ("inline", "deferred"):
        raise ValueError(f"kv_write={kv_write!r}: expected inline or deferred")
    if deferred:
        if t != 1:
            raise ValueError("deferred KV writes require T == 1 decode steps")
        if isinstance(cache.k, list):
            raise ValueError("deferred KV writes need the STACKED cache layout "
                             "(init_caches(as_lists=False))")
    if isinstance(pos, int):
        host_pos = pos
        positions = torch.arange(pos, pos + t, device=x.device)
    else:
        positions = pos.reshape(1) + torch.arange(t, device=x.device)
    cos_t, sin_t = _rope_tables(cfg, cache.max_seq, x.device)
    cos, sin = cos_t[positions], sin_t[positions]
    scale = 1.0 / math.sqrt(cfg.attention_scores_scalar or cfg.head_size)
    levels = _prefix_levels(cache.max_seq, attn_block)
    filled = None if host_pos is None else host_pos + t - deferred
    layers = _layers(params)
    fresh_k, fresh_v = [], []
    for i, (layer, win) in enumerate(
            zip(layers, _layer_windows(cfg, len(layers)))):
        q, k, v = _tp_heads(tp, cfg, *_qkv(
            layer, cfg, x, cos, sin,
            pre_norm=(layer["norm1_w"], cfg.norm_eps)))
        k_l, v_l = layer_entry(cache.k, i), layer_entry(cache.v, i)
        if deferred:
            fresh_k.append(k)
            fresh_v.append(v)
        else:
            update_layer(k_l, v_l, k, v, pos)
        attn = decode_attention(q, k_l, v_l, positions, scale=scale,
                                key_valid=key_valid,
                                logit_softcap=cfg.attention_logit_softcapping,
                                window=win, prefix_levels=levels,
                                fresh_kv=(k, v) if deferred else None,
                                filled=filled)
        x = matmul(_tp_out(tp, attn), layer["attn_proj_w"], residual=x)
        x = _mlp_block(layer, x, cfg)
    if deferred:
        update_stacked(cache.k, cache.v, torch.stack(fresh_k),
                       torch.stack(fresh_v), pos)
    return rms_norm(x, params["ln_f_w"], cfg.norm_eps), cache
