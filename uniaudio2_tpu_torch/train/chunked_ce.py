"""Chunked (logit-free) softmax cross-entropy for the big-vocab heads
(port of `uniaudio2_tpu/train/chunked_ce.py`).

    loss = sum over masked rows of ( logsumexp(h @ W) - (h @ W)[y] )

with an online logsumexp over vocab chunks forward and a backward that
recomputes each chunk's logits and accumulates ``dh`` / ``dW`` chunk by
chunk in float32: no (N, V) tensor exists in either pass, only one
(N, chunk) block. Accuracy comes from a running argmax (no gradient).

The chunk products are plain float32 ``torch.matmul`` (the JAX package
leaves them to XLA, outside any Pallas kernel). The last chunk is cut to
the vocabulary instead of padding ``W`` (the JAX code pads and masks the
pad to -1e30, which adds exact zeros to the sums and never wins the max).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _chunks(v: int, chunk: int):
    for lo in range(0, v, chunk):
        yield lo, min(lo + chunk, v)


class _MaskedCESums(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, y, mask, chunk):
        n = h.shape[0]
        hc = h.float()
        dev = h.device
        m_run = torch.full((n,), NEG_INF, device=dev)
        s_run = torch.zeros((n,), device=dev)
        best = torch.full((n,), NEG_INF, device=dev)
        best_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
        gold = torch.zeros((n,), device=dev)
        for lo, hi in _chunks(w.shape[1], chunk):
            logits = hc @ w[:, lo:hi].float()                       # (N, c)
            cmax, carg = logits.max(dim=-1)
            m_new = torch.maximum(m_run, cmax)
            s_run = s_run * torch.exp(m_run - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m_run = m_new
            best_idx = torch.where(cmax > best, carg + lo, best_idx)
            best = torch.maximum(best, cmax)
            in_chunk = (y >= lo) & (y < hi)
            gval = logits.gather(1, (y - lo).clamp(0, hi - lo - 1)[:, None])[:, 0]
            gold = torch.where(in_chunk, gval, gold)
        logz = m_run + torch.log(s_run)
        nll_sum = ((logz - gold) * mask.float()).sum()
        acc_sum = ((best_idx == y) & mask).float().sum()
        ctx.save_for_backward(h, w, y, mask, logz)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(acc_sum)
        return nll_sum, acc_sum

    @staticmethod
    def backward(ctx, g_nll, g_acc):
        h, w, y, mask, logz = ctx.saved_tensors
        hc = h.float()
        scale = (mask.float() * g_nll)[:, None]                     # (N, 1)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for lo, hi in _chunks(w.shape[1], ctx.chunk):
            wc = w[:, lo:hi].float()
            p = torch.exp(hc @ wc - logz[:, None])                  # softmax chunk
            cols = torch.arange(lo, hi, device=y.device)
            dlog = (p - (y[:, None] == cols[None, :]).float()) * scale
            dh += dlog @ wc.T
            dw[:, lo:hi] = hc.T @ dlog
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def masked_ce_sums(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE over ``h @ w`` without materialising the logits.

    h: (N, D) hidden states (any float dtype; math in f32); w: (D, V);
    y: (N,) int targets; mask: (N,) bool; chunk: vocab-chunk width.
    Returns (nll_sum, acc_sum): masked sums (normalise by the mask count
    outside). Only ``h`` and ``w`` get gradients."""
    return _MaskedCESums.apply(h, w, y.long(), mask.bool(), chunk)


def masked_ce(h, w, y, mask, chunk: int = 2048):
    """Mean masked CE + accuracy (same contract as `losses._masked_ce` but
    taking hidden states + head weights)."""
    nll_sum, acc_sum = masked_ce_sums(h, w, y, mask, chunk)
    denom = torch.clamp_min(mask.float().sum(), 1.0)
    return nll_sum / denom, acc_sum / denom
