"""Training losses for the unified 9-stream audio LM (port of
`uniaudio2_tpu/train/losses.py`).

Same semantics as the reference's three criteria
(reference `llm_models/model_new.py:38-109`):

* ``ce_zero``     — codebook-0 CE, mean over masked steps;
* ``ce_text``     — text-stream CE, mean over masked steps;
* ``ce_residual`` — per-codebook CE for codebooks 1..7 with per-codebook
  weights, averaged over the codebook count, normalised by the number of
  masked audio steps.

The local decoder runs at every step (or at gathered audio steps) and the
masks select the loss, so shapes stay static. All reductions are float32.

``total`` (data parallelism on a mesh) sums a count over the
data-parallel ranks: each rank divides its own rows' sums by the global
mask counts, so the ranks' losses add up to the global batch's loss.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from uniaudio2_tpu_torch.train import chunked_ce


def _nll_and_pred(logits: torch.Tensor, y: torch.Tensor):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y.long()[..., None])[..., 0]
    return logz - gold, logits.argmax(dim=-1)


def denom(mask: torch.Tensor, total=None) -> torch.Tensor:
    """max(1, the mask's count), over every data-parallel rank's rows when
    ``total`` is given."""
    n = mask.float().sum()
    return torch.clamp_min(n if total is None else total(n), 1.0)


def _masked_ce(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               total=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE and accuracy under a boolean mask, both normalised
    by the mask count. logits (..., V); y, mask (...)."""
    nll, pred = _nll_and_pred(logits, y)
    m = mask.float()
    denom_ = denom(mask, total)
    loss = (nll * m).sum() / denom_
    acc = ((pred == y) & mask).float().sum() / denom_
    return loss, acc


def ce_text(text_logits, y, mask, total=None):
    """Text-stream loss (reference `CrossEntropyAndAccuracy_text`)."""
    loss, acc = _masked_ce(text_logits, y, mask, total)
    return loss, {"loss_text": loss, "acc_text": acc}


def ce_zero(logits_cb0, y_cb0, mask, total=None):
    """Codebook-0 loss (reference `CrossEntropyAndAccuracy_zero`)."""
    loss, acc = _masked_ce(logits_cb0, y_cb0, mask, total)
    return loss, {"loss_0": loss, "acc_0": acc}


def ce_residual(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                weights: Sequence[float], total=None):
    """Residual-codebook loss (reference `CrossEntropyAndAccuracy_residual`).
    logits (B, S, R, V); y (B, S, R); mask (B, S); weights: R floats."""
    r = logits.shape[2]
    assert len(weights) == r
    w = torch.tensor(list(weights), dtype=torch.float32, device=logits.device)
    nll, pred = _nll_and_pred(logits, y)
    mf = mask[..., None].float()
    denom_ = denom(mask, total)
    per_cb = (nll * mf).sum(dim=(0, 1)) / denom_                 # (R,)
    loss = (per_cb * w).sum() / r
    acc = ((pred == y) & mask[..., None]).float().sum(dim=(0, 1)) / denom_
    metrics = {f"loss_{i + 1}": per_cb[i] for i in range(r)}
    metrics.update({f"acc_{i + 1}": acc[i] for i in range(r)})
    return loss, metrics


def unified_loss(text_logits, audio_logits, text_labels, audio_labels,
                 text_loss_mask, audio_loss_mask,
                 residual_weights: Sequence[float] = (1.0,) * 7, total=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss of one training step from dense logits:
    text_logits (B, S, V_text), audio_logits (B, S, 8, V_audio),
    text_labels (B, S), audio_labels (B, S, 8), masks (B, S) bool."""
    l_text, m_text = ce_text(text_logits, text_labels, text_loss_mask, total)
    l_zero, m_zero = ce_zero(audio_logits[:, :, 0, :], audio_labels[:, :, 0],
                             audio_loss_mask, total)
    l_res, m_res = ce_residual(audio_logits[:, :, 1:, :], audio_labels[:, :, 1:],
                               audio_loss_mask, residual_weights, total)
    loss = l_text + l_zero + l_res
    metrics = {"loss": loss}
    metrics.update(m_text)
    metrics.update(m_zero)
    metrics.update(m_res)
    return loss, metrics


def unified_loss_fused(h_final, lm_head_w, dec_h, audio_head, text_labels,
                       audio_labels, text_loss_mask, audio_loss_mask,
                       residual_weights: Sequence[float] = (1.0,) * 7,
                       chunk: int = 2048, total=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`unified_loss` from hidden states through the chunked CE: h_final
    (B, S, D), lm_head_w (D, V_text), dec_h (B·N, 8, D_dec) (N = S, or the
    gather capacity C with labels / mask in the same gathered space),
    audio_head (8, D_dec, V_audio)."""
    b, s, d = h_final.shape
    t_nll, t_acc = chunked_ce.masked_ce_sums(
        h_final.reshape(b * s, d), lm_head_w, text_labels.reshape(-1),
        text_loss_mask.reshape(-1), chunk)
    t_den = denom(text_loss_mask, total)
    l_text, acc_text = t_nll / t_den, t_acc / t_den
    ncb = dec_h.shape[1]
    amask = audio_loss_mask.reshape(-1)
    y = audio_labels.reshape(dec_h.shape[0], ncb)
    # unbind: one backward stack per operand, not a zero-filled full copy
    # per codebook as eight separate index views would cost
    sums = [chunked_ce.masked_ce_sums(hh, ww, y[:, i], amask, chunk)
            for i, (hh, ww) in enumerate(zip(dec_h.unbind(1),
                                             audio_head.unbind(0)))]
    a_den = denom(amask, total)
    per_cb = torch.stack([nll for nll, _ in sums]) / a_den
    acc_cb = torch.stack([acc for _, acc in sums]) / a_den
    r = ncb - 1
    assert len(residual_weights) == r
    wts = torch.tensor(list(residual_weights), dtype=torch.float32,
                       device=h_final.device)
    l_zero = per_cb[0]
    l_res = (per_cb[1:] * wts).sum() / r
    loss = l_text + l_zero + l_res
    metrics = {"loss": loss, "loss_text": l_text, "acc_text": acc_text,
               "loss_0": l_zero, "acc_0": acc_cb[0]}
    metrics.update({f"loss_{i + 1}": per_cb[i + 1] for i in range(r)})
    metrics.update({f"acc_{i + 1}": acc_cb[i + 1] for i in range(r)})
    return loss, metrics
