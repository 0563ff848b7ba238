"""WavLM encoder, the codec's phone-level feature tower (port of
`uniaudio2_tpu/codec/wavlm_encoder.py`).

* a conv feature extractor (WavLM-base: 7 layers of 512 channels, k
  10/3/3/3/3/2/2, s 5/2/2/2/2/2/2, no bias), a per-channel GroupNorm after
  conv 0, exact GELU: 16 kHz -> 50 Hz;
* feature projection LayerNorm + Linear;
* a grouped conv positional embedding (k 128, 16 groups, one-sample trim
  for an even kernel), added, then LayerNorm;
* post-norm layers whose attention adds a gated relative position bias:
  T5-style log buckets (built in numpy) embedded per head, gated by
  ``a (b c - 1) + 2`` from sigmoid projections of each head's input.

`phone_features` averages hidden states 6..9 (index 0 is the embedding).

Params (JAX key names; layers stacked on a leading L): convs [{"w" (k,
C_in, C_out), conv 0 also "gn_w"/"gn_b"}], fp_ln_w/b, fp_w/b, pos_conv_w
(K, D / groups, D), pos_conv_b, ln0_w/b, rel_attn_embed (buckets, H),
layers: q/k/v/out _w/_b, gru_w (hd, 8), gru_b, gru_const (H,), ln1_w/b,
ff1_w/b, ff2_w/b, ln2_w/b.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.codec.layers import (
    attend, conv, gelu, instance_norm_time, layer, layer_norm, normal, scores,
    split_heads,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class WavLMConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    num_buckets: int = 320
    max_distance: int = 800
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    # hidden states averaged as phone features (6..9)
    phone_layers: Tuple[int, int] = (6, 10)

    @classmethod
    def base(cls) -> "WavLMConfig":
        return cls()

    @classmethod
    def tiny_test(cls) -> "WavLMConfig":
        return cls(conv_dim=(16,) * 3, conv_kernel=(10, 3, 2),
                   conv_stride=(5, 2, 2), hidden_size=32, num_layers=2,
                   num_heads=2, ffn_dim=64, num_buckets=32, max_distance=50,
                   pos_conv_kernel=16, pos_conv_groups=2,
                   phone_layers=(1, 3))


def init_params(generator: torch.Generator, cfg: WavLMConfig,
                dtype=torch.float32, device="cuda") -> Params:
    d, l, f = cfg.hidden_size, cfg.num_layers, cfg.ffn_dim
    hd = d // cfg.num_heads

    def n(*shape):
        return normal(generator, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    convs, cin = [], 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        c_p = {"w": n(k, cin, c)}
        if i == 0:
            c_p["gn_w"], c_p["gn_b"] = full(1.0, c), full(0.0, c)
        convs.append(c_p)
        cin = c
    return {
        "convs": convs,
        "fp_ln_w": full(1.0, cfg.conv_dim[-1]), "fp_ln_b": full(0.0, cfg.conv_dim[-1]),
        "fp_w": n(cfg.conv_dim[-1], d), "fp_b": full(0.0, d),
        "pos_conv_w": n(cfg.pos_conv_kernel, d // cfg.pos_conv_groups, d),
        "pos_conv_b": full(0.0, d),
        "ln0_w": full(1.0, d), "ln0_b": full(0.0, d),
        "rel_attn_embed": n(cfg.num_buckets, cfg.num_heads),
        "layers": {
            "q_w": n(l, d, d), "q_b": full(0.0, l, d),
            "k_w": n(l, d, d), "k_b": full(0.0, l, d),
            "v_w": n(l, d, d), "v_b": full(0.0, l, d),
            "out_w": n(l, d, d), "out_b": full(0.0, l, d),
            "gru_w": n(l, hd, 8), "gru_b": full(0.0, l, 8),
            "gru_const": full(1.0, l, cfg.num_heads),
            "ln1_w": full(1.0, l, d), "ln1_b": full(0.0, l, d),
            "ff1_w": n(l, d, f), "ff1_b": full(0.0, l, f),
            "ff2_w": n(l, f, d), "ff2_b": full(0.0, l, d),
            "ln2_w": full(1.0, l, d), "ln2_b": full(0.0, l, d),
        },
    }


@functools.lru_cache(maxsize=8)
def relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5/WavLM log-bucketed relative positions, (T, T) int32."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets.astype(np.int32)


def feature_extractor(params: Params, cfg: WavLMConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, T / 320, conv_dim[-1]) at 50 Hz."""
    x = wav[:, :, None].to(params["convs"][0]["w"].dtype)
    for i, (c_p, st) in enumerate(zip(params["convs"], cfg.conv_stride)):
        x = conv(x, c_p["w"], stride=st)
        if i == 0:
            x = instance_norm_time(x, c_p["gn_w"], c_p["gn_b"])
        x = gelu(x)
    return x


def positional_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    kernel: int, groups: int) -> torch.Tensor:
    """The grouped conv positional embedding (padding kernel // 2 a side,
    the last frame dropped for an even kernel), before its GELU."""
    pos = conv(h, w, padding=kernel // 2, groups=groups).to(h.dtype) + b
    return pos[:, :-1] if kernel % 2 == 0 else pos


def forward(params: Params, cfg: WavLMConfig, wav: torch.Tensor) -> List[torch.Tensor]:
    """(B, T) waveform -> hidden states [h_0 .. h_L] (index 0 = the
    pre-layer embedding)."""
    eps = cfg.layer_norm_eps
    h = layer_norm(feature_extractor(params, cfg, wav), params["fp_ln_w"],
                   params["fp_ln_b"], eps)
    h = h @ params["fp_w"] + params["fp_b"]
    h = h + gelu(positional_conv(h, params["pos_conv_w"], params["pos_conv_b"],
                                 cfg.pos_conv_kernel, cfg.pos_conv_groups))
    h = layer_norm(h, params["ln0_w"], params["ln0_b"], eps)

    b, t, d = h.shape
    heads = cfg.num_heads
    hd = d // heads
    buckets = torch.from_numpy(
        relative_position_buckets(t, cfg.num_buckets, cfg.max_distance)).to(h.device)
    pos_bias = params["rel_attn_embed"][buckets.long()].permute(2, 0, 1)[None]
    hidden = [h]
    for i in range(params["layers"]["q_w"].shape[0]):
        lp = layer(params["layers"], i)
        proj = split_heads(h, heads) @ lp["gru_w"] + lp["gru_b"]   # (B, H, T, 8)
        gates = torch.sigmoid(proj.reshape(b, heads, t, 2, 4).sum(-1))
        gate_out = gates[..., 0] * (gates[..., 1] * lp["gru_const"][None, :, None]
                                    - 1.0) + 2.0
        gated_bias = gate_out[..., None] * pos_bias                 # (B, H, T, T)
        q = split_heads(h @ lp["q_w"] + lp["q_b"], heads)
        k = split_heads(h @ lp["k_w"] + lp["k_b"], heads)
        v = split_heads(h @ lp["v_w"] + lp["v_b"], heads)
        o = attend(scores(q, k) * (hd ** -0.5) + gated_bias.float(), v)
        h = layer_norm(h + (o @ lp["out_w"] + lp["out_b"]), lp["ln1_w"],
                       lp["ln1_b"], eps)
        h = h + (gelu(h @ lp["ff1_w"] + lp["ff1_b"]) @ lp["ff2_w"] + lp["ff2_b"])
        h = layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)
        hidden.append(h)
    return hidden


def phone_features(params: Params, cfg: WavLMConfig, wav: torch.Tensor) -> torch.Tensor:
    """The mean of hidden states ``phone_layers`` (6..9): (B, T50, D)."""
    lo, hi = cfg.phone_layers
    return torch.stack(forward(params, cfg, wav)[lo:hi], 0).mean(0)
