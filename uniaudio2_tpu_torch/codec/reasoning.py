"""Reasoning branch ("AudioThinking"): CLS-query encoder + reasoning RVQ
(port of `uniaudio2_tpu/codec/reasoning.py`).

1. whisper features (50 Hz) are stride-2 conv-downsampled to 25 Hz,
   concatenated with the BEST-RQ semantic features (25 Hz) and merged to
   ``dim``;
2. a learned CLS token follows every ``interval`` (5) frames;
3. a non-causal transformer: qk-norm, partial RoPE (half-split, on the
   first ``rope_dim`` channels of each head), sigmoid-GLU feed-forward,
   LayerScale, no pre-norms;
4. the CLS positions (5 Hz) are quantized by the 8 x 4096 RVQ.

Params (JAX key names; blocks stacked on a leading L): cls_token (D,),
whisper_down {"w" (2, Dw, Dw), "b"}, merge_proj {"w", "b"}, blocks: qkv_w,
q_norm_w/b, k_norm_w/b, attn_out_w, attn_scale, glu_w/b, ff_out_w/b,
ff_scale; rvq (`rvq.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from uniaudio2_tpu_torch.codec import rvq
from uniaudio2_tpu_torch.codec.layers import (
    attend, conv, layer, layer_norm, normal, scores, split_heads,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class ReasoningConfig:
    dim: int = 768
    head_dim: int = 128            # -> 6 heads at dim 768
    depth: int = 5
    interval: int = 5
    whisper_dim: int = 1024
    bestrq_dim: int = 1024
    rope_dim: int = 64
    ff_mult: int = 4
    codebook_size: int = 4096
    codebook_dim: int = 64
    num_quantizers: int = 8
    layer_scale_init: float = 1e-2

    @property
    def num_heads(self) -> int:
        return self.dim // self.head_dim

    @classmethod
    def tiny_test(cls) -> "ReasoningConfig":
        return cls(dim=32, head_dim=16, depth=2, whisper_dim=24,
                   bestrq_dim=16, rope_dim=8, codebook_size=16,
                   codebook_dim=8, num_quantizers=4)


def init_params(generator: torch.Generator, cfg: ReasoningConfig,
                dtype=torch.float32, device="cuda") -> Params:
    d, l, f = cfg.dim, cfg.depth, cfg.dim * cfg.ff_mult
    hd, wd = cfg.head_dim, cfg.whisper_dim

    def n(*shape):
        return normal(generator, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "cls_token": normal(generator, (d,), 1.0, dtype, device),
        "whisper_down": {"w": n(2, wd, wd), "b": full(0.0, wd)},
        "merge_proj": {"w": n(wd + cfg.bestrq_dim, d), "b": full(0.0, d)},
        "blocks": {
            "qkv_w": n(l, d, 3 * d),
            "q_norm_w": full(1.0, l, hd), "q_norm_b": full(0.0, l, hd),
            "k_norm_w": full(1.0, l, hd), "k_norm_b": full(0.0, l, hd),
            "attn_out_w": n(l, d, d),
            "attn_scale": full(cfg.layer_scale_init, l, d),
            "glu_w": n(l, d, 2 * f), "glu_b": full(0.0, l, 2 * f),
            "ff_out_w": n(l, f, d), "ff_out_b": full(0.0, l, d),
            "ff_scale": full(cfg.layer_scale_init, l, d),
        },
        "rvq": rvq.init_params(generator, dim=d, codebook_size=cfg.codebook_size,
                               codebook_dim=cfg.codebook_dim,
                               num_quantizers=cfg.num_quantizers, dtype=dtype,
                               device=device),
    }


def rope_tables(t: int, rope_dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """x-transformers convention: inverse frequencies over ``rope_dim``,
    the table duplicated; cos and sin (T, rope_dim) in float32."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, rope_dim, 2, dtype=torch.float32,
                                          device=device) / rope_dim))
    freqs = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None]
    freqs = torch.cat([freqs, freqs], -1)
    return torch.cos(freqs), torch.sin(freqs)


def apply_partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       rope_dim: int) -> torch.Tensor:
    """Rotate the first ``rope_dim`` channels of each head (half-split)."""
    rot, rest = x[..., :rope_dim], x[..., rope_dim:]
    half = rope_dim // 2
    rotated = torch.cat([-rot[..., half:], rot[..., :half]], -1)
    return torch.cat([rot * cos + rotated * sin, rest], -1)


def interleave_cls(x: torch.Tensor, cls_token: torch.Tensor, interval: int) -> torch.Tensor:
    """(B, T, D) with T % interval == 0 -> (B, T + T // interval, D): a CLS
    token after every ``interval`` frames."""
    b, t, d = x.shape
    g = t // interval
    cls = cls_token.to(x.dtype).expand(b, g, 1, d)
    return torch.cat([x.reshape(b, g, interval, d), cls], 2).reshape(
        b, g * (interval + 1), d)


def extract_cls(x: torch.Tensor, interval: int) -> torch.Tensor:
    """(B, G (interval + 1), D) -> the CLS positions (B, G, D)."""
    b, n, d = x.shape
    return x.reshape(b, n // (interval + 1), interval + 1, d)[:, :, interval]


def transformer(params: Params, cfg: ReasoningConfig, x: torch.Tensor) -> torch.Tensor:
    heads, d = cfg.num_heads, cfg.dim
    cos, sin = rope_tables(x.shape[1], cfg.rope_dim, x.device)
    for i in range(params["blocks"]["qkv_w"].shape[0]):
        lp = layer(params["blocks"], i)
        q, k, v = (split_heads(z, heads) for z in (x @ lp["qkv_w"]).split(d, -1))
        q = apply_partial_rope(layer_norm(q, lp["q_norm_w"], lp["q_norm_b"]),
                               cos, sin, cfg.rope_dim)
        k = apply_partial_rope(layer_norm(k, lp["k_norm_w"], lp["k_norm_b"]),
                               cos, sin, cfg.rope_dim)
        o = attend(scores(q, k) * (cfg.head_dim ** -0.5), v) @ lp["attn_out_w"]
        x = x + o * lp["attn_scale"]
        val, gate = (x @ lp["glu_w"] + lp["glu_b"]).chunk(2, -1)
        ff = (val * torch.sigmoid(gate)) @ lp["ff_out_w"] + lp["ff_out_b"]
        x = x + ff * lp["ff_scale"]
    return x


def encode(params: Params, cfg: ReasoningConfig, whisper_feats: torch.Tensor,
           bestrq_semantic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """whisper (B, T50, Dw), BEST-RQ semantic (B, T25, Db) ->
    (reason_codes (B, T5, Q) int32, quantized (B, T5, dim))."""
    down = params["whisper_down"]
    w = conv(whisper_feats, down["w"], stride=2).to(whisper_feats.dtype) + down["b"]
    tl = min(w.shape[1], bestrq_semantic.shape[1])
    tl -= tl % cfg.interval            # the CLS interleave needs whole groups
    fused = torch.cat([w[:, :tl], bestrq_semantic[:, :tl]], -1)
    fused = fused @ params["merge_proj"]["w"] + params["merge_proj"]["b"]
    x = transformer(params, cfg, interleave_cls(fused, params["cls_token"],
                                                cfg.interval))
    return rvq.encode(params["rvq"], extract_cls(x, cfg.interval))
