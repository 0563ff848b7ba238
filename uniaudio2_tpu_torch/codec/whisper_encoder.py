"""Whisper audio encoder, the codec's first frozen feature tower (port of
`uniaudio2_tpu/codec/whisper_encoder.py`).

Two exact-GELU convs (k 3, the second stride 2) from n_mels to d_model, a
learned position table cut to the stem's length, pre-norm blocks (MHA with
bias except k_proj, float32 softmax, GELU MLP), a final LayerNorm. 50 Hz
out.

Params (JAX key names; layers stacked on a leading L):
    conv1/conv2: {"w": (k, C_in, C_out), "b"}
    pos_embed: (max_positions, D)
    layers: ln1_w/b, q_w/b, k_w, v_w/b, out_w/b, ln2_w/b, fc1_w/b, fc2_w/b
    ln_f_w, ln_f_b
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from uniaudio2_tpu_torch.codec.layers import (
    attend, conv, gelu, layer, layer_norm, normal, scores, split_heads,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    d_model: int = 1024        # whisper-medium
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 1500

    @classmethod
    def medium(cls) -> "WhisperEncoderConfig":
        return cls()

    @classmethod
    def tiny_test(cls) -> "WhisperEncoderConfig":
        return cls(n_mels=8, d_model=32, n_layers=2, n_heads=2, ffn_dim=64,
                   max_positions=64)


def init_params(generator: torch.Generator, cfg: WhisperEncoderConfig,
                dtype=torch.float32, device="cuda") -> Params:
    d, l, f = cfg.d_model, cfg.n_layers, cfg.ffn_dim

    def n(*shape):
        return normal(generator, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "conv1": {"w": n(3, cfg.n_mels, d), "b": full(0.0, d)},
        "conv2": {"w": n(3, d, d), "b": full(0.0, d)},
        "pos_embed": n(cfg.max_positions, d),
        "layers": {
            "ln1_w": full(1.0, l, d), "ln1_b": full(0.0, l, d),
            "q_w": n(l, d, d), "q_b": full(0.0, l, d),
            "k_w": n(l, d, d),
            "v_w": n(l, d, d), "v_b": full(0.0, l, d),
            "out_w": n(l, d, d), "out_b": full(0.0, l, d),
            "ln2_w": full(1.0, l, d), "ln2_b": full(0.0, l, d),
            "fc1_w": n(l, d, f), "fc1_b": full(0.0, l, f),
            "fc2_w": n(l, f, d), "fc2_b": full(0.0, l, d),
        },
        "ln_f_w": full(1.0, d), "ln_f_b": full(0.0, d),
    }


def forward(params: Params, cfg: WhisperEncoderConfig, mels: torch.Tensor) -> torch.Tensor:
    """(B, T_mel, n_mels) log-mels -> (B, T_mel // 2, d_model) at 50 Hz."""
    dtype = params["conv1"]["w"].dtype
    h = gelu(conv(mels.to(dtype), params["conv1"]["w"], params["conv1"]["b"],
                  padding=1))
    h = gelu(conv(h, params["conv2"]["w"], params["conv2"]["b"], stride=2,
                  padding=1))
    h = h + params["pos_embed"][: h.shape[1]][None].to(h.dtype)
    heads = cfg.n_heads
    scale = (cfg.d_model // heads) ** -0.5
    for i in range(params["layers"]["q_w"].shape[0]):
        lp = layer(params["layers"], i)
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q = (hn @ lp["q_w"] + lp["q_b"]) * scale
        k = hn @ lp["k_w"]                          # k_proj has no bias
        v = hn @ lp["v_w"] + lp["v_b"]
        o = attend(scores(split_heads(q, heads), split_heads(k, heads)),
                   split_heads(v, heads))
        h = h + (o @ lp["out_w"] + lp["out_b"])
        hn = layer_norm(h, lp["ln2_w"], lp["ln2_b"])
        h = h + (gelu(hn @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"])
    return layer_norm(h, params["ln_f_w"], params["ln_f_b"])
