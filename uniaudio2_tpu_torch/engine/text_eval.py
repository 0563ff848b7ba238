"""Text-only evaluation harnesses: perplexity and free-form QA (port of
`uniaudio2_tpu/engine/text_eval.py`).

The reference's text sanity harnesses (`evaluation/text_llama.py` /
`text_llm.py` / `text_mllm.py` / `text_mllm_qa.py`) exercise
`forward_text` for perplexity and text generation on the unified model:

* ``text_perplexity``: teacher-forced NLL/PPL of text sequences through
  the full unified stack (text stream active, audio streams masked), one
  sequence at a time, on the device of the parameters;
* ``generate_text_answer``: prompt -> sampled/greedy continuation through
  the decode engine.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.engine import tasks as taskmod
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.models import unified


def text_perplexity(
    params,
    cfg: UnifiedModelConfig,
    token_seqs: Sequence[Sequence[int]],
) -> Dict[str, float]:
    """Corpus perplexity over text-only sequences (BOS..EOS included)."""
    device = params["audio_embeddings"].device
    par = cfg.tokens.parallel_number
    total_nll = 0.0
    total_tokens = 0
    for seq in token_seqs:
        ids = np.asarray(seq, np.int64)
        s = len(ids)
        if s < 2:
            continue
        grid = np.zeros((1, s, par), np.int64)
        grid[0, :, -1] = ids
        mask = np.zeros((1, s, par), bool)
        mask[0, :, -1] = True
        tokens = torch.from_numpy(grid).to(device)
        with torch.no_grad():
            logits = unified.forward_text(params, cfg, tokens,
                                          torch.from_numpy(mask).to(device))
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            gold = torch.gather(logp, -1, tokens[:, 1:, -1:])[..., 0]
        total_nll += -float(gold.sum())
        total_tokens += s - 1
    avg = total_nll / max(total_tokens, 1)
    return {
        "nll": avg,
        "ppl": math.exp(min(avg, 50.0)),
        "tokens": total_tokens,
    }


def generate_text_answer(
    engine: DecodeEngine,
    prompt_ids: Sequence[int],
    *,
    temperature: float = 0.9,
    topk: int = 50,
    seed: int = 888,
) -> np.ndarray:
    """Free-form text continuation of a text-only prompt (the reference's
    `generate_text`, `text_mllm_qa.py:223`)."""
    ids = np.asarray(prompt_ids, np.int64)
    grid = taskmod.text_pad(ids, engine.cfg.tokens)
    mask = np.zeros_like(grid, bool)
    mask[:, -1] = True
    return engine.generate_text(
        grid, mask, temperature=temperature, topk=topk, seed=seed
    )
