"""ASR text post-processing: degenerate-repetition cleanup (port of
`uniaudio2_tpu/engine/postprocess.py`).

The reference's `post_process_text` pipeline
(`evaluation/asr_task.py:58-172`), used to repair the
tail-looping failure mode of greedy ASR decoding: (1) trim tail words that
repeat ≥ ``max_repeat`` times within a recent window, (2) if the result is
still dominated by one token, cut at the first repeated bigram, (3) tidy
whitespace/punctuation. Works for both space-delimited and CJK text
(CJK strings are treated per-character when no spaces are present).
"""

from __future__ import annotations

import re
from typing import List

_PUNCT = ".,!?;，。！？；"
_CJK = re.compile(r"[一-鿿㐀-䶿]")


def _tokens(text: str) -> List[str]:
    words = text.strip().split()
    if len(words) <= 1 and _CJK.search(text):
        return list(text.strip())
    return words


def _join(tokens: List[str], cjk: bool) -> str:
    return "".join(tokens) if cjk else " ".join(tokens)


def _clean_tok(w: str) -> str:
    return w.lower().strip(_PUNCT)


def remove_tail_repetition(text: str, max_repeat: int = 3) -> str:
    """Cut the tail at the first occurrence of a word that repeats
    ``max_repeat``+ times within a trailing 10-token window."""
    cjk = bool(_CJK.search(text)) and " " not in text.strip()
    toks = _tokens(text)
    if len(toks) <= 1:
        return text
    for i in range(len(toks) - 1, 0, -1):
        cur = _clean_tok(toks[i])
        if not cur:
            continue
        start = max(0, i - min(10, len(toks)))
        count = sum(1 for j in range(start, i) if _clean_tok(toks[j]) == cur)
        if count >= max_repeat:
            for k in range(i - 1, -1, -1):
                if _clean_tok(toks[k]) == cur:
                    return _join(toks[: k + 1], cjk)
    return text


def has_excessive_repetition(text: str, threshold: int = 2) -> bool:
    toks = _tokens(text)
    if len(toks) < 5:
        return False
    counts = {}
    for w in toks:
        c = _clean_tok(w)
        if len(c) > 2 or (_CJK.match(c) if c else False):
            counts[c] = counts.get(c, 0) + 1
    top = max(counts.values()) if counts else 0
    return top > threshold and top > len(toks) * 0.3


def cut_at_repeated_phrase(text: str) -> str:
    """Stop at the first re-seen trigram (the reference's aggressive mode)."""
    cjk = bool(_CJK.search(text)) and " " not in text.strip()
    toks = _tokens(text)
    if len(toks) <= 3:
        return text
    seen = set()
    out: List[str] = []
    for w in toks:
        cur = _clean_tok(w)
        if len(out) >= 2:
            phrase = " ".join(_clean_tok(t) for t in out[-2:]) + " " + cur
            if phrase in seen:
                break
            seen.add(phrase)
        out.append(w)
    return _join(out, cjk)


def clean_text(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"\s*([.,!?;])\s*", r"\1 ", text)
    return text.strip()


def post_process_text(text: str, max_repeat: int = 3) -> str:
    if not text:
        return text
    out = remove_tail_repetition(text, max_repeat)
    if has_excessive_repetition(out):
        out = cut_at_repeated_phrase(out)
    return clean_text(out)
