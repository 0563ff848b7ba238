"""Residual vector quantization (port of `uniaudio2_tpu/codec/rvq.py`).

decode: sum the selected codebook vectors across quantizers in the
``codebook_dim`` space, then apply the shared output projection.
encode: the shared input projection, then per quantizer the squared-L2
nearest codebook entry, ``argmin(|c|^2 - 2 r.c)`` in float32 as the JAX
function writes it (not ``torch.cdist``, whose sums run in another order;
both argmins take the first index on a tie), and the residual update.

Params (JAX key names and layouts):
    {"project_in_w": (dim, cb_dim), "project_in_b": (cb_dim,),
     "project_out_w": (cb_dim, dim), "project_out_b": (dim,),
     "codebooks": (Q, K, cb_dim)}
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def init_params(generator: torch.Generator, *, dim: int, codebook_size: int,
                codebook_dim: int, num_quantizers: int, dtype=torch.float32,
                device="cuda") -> Params:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    return {
        "project_in_w": (normal(dim, codebook_dim) * 0.02).to(dtype),
        "project_in_b": torch.zeros((codebook_dim,), dtype=dtype, device=device),
        "project_out_w": (normal(codebook_dim, dim) * 0.02).to(dtype),
        "project_out_b": torch.zeros((dim,), dtype=dtype, device=device),
        "codebooks": normal(num_quantizers, codebook_size, codebook_dim).to(dtype),
    }


def _gather(codebooks: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """codebooks (Q, K, d), indices (..., T, Q) -> (..., T, Q, d)."""
    q = torch.arange(codebooks.shape[0], device=codebooks.device)
    return codebooks[q, indices.long()]


def decode(params: Params, indices: torch.Tensor) -> torch.Tensor:
    """(..., T, Q) int codes (quantizer axis last) -> (..., T, dim)."""
    q = params["codebooks"].shape[0]
    if indices.shape[-1] != q:
        raise ValueError(f"rvq.decode: {indices.shape[-1]} code columns, {q} "
                         f"quantizers")
    summed = _gather(params["codebooks"], indices).sum(dim=-2)
    return summed @ params["project_out_w"] + params["project_out_b"]


def distances(residual: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., T, d) residuals, (K, d) codebook -> (..., T, K) float32
    ``|c|^2 - 2 r.c``, the quantity whose argmin is the nearest entry."""
    dots = residual.float() @ codebook.float().T
    sq = (codebook.float() ** 2).sum(dim=-1)
    return sq - 2.0 * dots


def encode(params: Params, x: torch.Tensor):
    """(..., T, dim) features -> (indices (..., T, Q) int32, quantized
    (..., T, dim))."""
    residual = x @ params["project_in_w"] + params["project_in_b"]
    indices, chosen = [], []
    for codebook in params["codebooks"]:
        idx = torch.argmin(distances(residual, codebook), dim=-1)
        c = codebook[idx]
        residual = residual - c
        indices.append(idx.to(torch.int32))
        chosen.append(c)
    quantized = torch.stack(chosen, dim=-2).sum(dim=-2)
    return (torch.stack(indices, dim=-1),
            quantized @ params["project_out_w"] + params["project_out_b"])
