"""Text tokenizer: Llama-3.2-vocab wrapper with frame-aligned padding (port
of `uniaudio2_tpu/text/tokenizer.py`, the reference `TextTokenizer`,
`tools/tokenizer/Text2ID/text_tokenizer.py:12-195`).

* loads either a HF ``tokenizer.json`` (through ``tokenizers``) or a
  sentencepiece model (through ``sentencepiece``) from a checkpoint
  directory, resolving BOS/EOS from ``tokenizer_config.json`` /
  ``generation_config.json``; both packages are imported only when a
  directory needs them;
* ``tokenize`` auto-adds BOS/EOS; ``decode`` maps ids back to text;
* reserved Llama-3 ids ``<pad>``=128004 and ``<epad>``=128005 implement the
  frame-aligned word placement of the timed-text tasks (`pad_tokens`):
  each word's subword ids are written at ``round(start·frame_rate)`` with an
  ``<epad>`` marker in the preceding free frame;
* ``word_alignment`` maps words to their subword ids ("▁"/"Ġ" word-start
  conventions).

Host-side pure Python: the ids feed the numpy grid functions of
`engine/tasks.py`.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

PAD_ID = 128004
EPAD_ID = 128005


def _maybe_fix_json(text: str) -> dict:
    """Tolerant JSON load (trailing commas: some released
    generation_config.json files are malformed)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        cleaned = re.sub(r",\s*([}\]])", r"\1", text)
        return json.loads(cleaned)


class TextTokenizer:
    def __init__(self, checkpoint_dir: Union[str, Path], max_length: int = -1):
        checkpoint_dir = Path(checkpoint_dir)
        if not checkpoint_dir.is_dir():
            raise NotADirectoryError(str(checkpoint_dir))
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None
        hf_file = checkpoint_dir / "tokenizer.json"
        if hf_file.is_file():
            from tokenizers import Tokenizer as HFTokenizer

            self._hf = HFTokenizer.from_file(str(hf_file))
            self._sp = None
            cfg_file = checkpoint_dir / "tokenizer_config.json"
            if cfg_file.is_file():
                cfg = json.loads(cfg_file.read_text(encoding="utf-8"))
                for attr, key in (("bos_id", "bos_token"), ("eos_id", "eos_token")):
                    tok = cfg.get(key)
                    if isinstance(tok, dict):
                        tok = tok.get("content")
                    if tok is not None:
                        setattr(self, attr, self.token_to_id(tok))
            gen_file = checkpoint_dir / "generation_config.json"
            if gen_file.is_file():
                cfg = _maybe_fix_json(gen_file.read_text(encoding="utf-8"))
                if self.bos_id is None:
                    self.bos_id = cfg.get("bos_token_id")
                if self.eos_id is None:
                    eos = cfg.get("eos_token_id")
                    self.eos_id = eos[0] if isinstance(eos, list) else eos
        else:
            sp_file = next(checkpoint_dir.glob("tokenizer*.model"), None)
            if sp_file is None:
                raise FileNotFoundError(f"no tokenizer in {checkpoint_dir}")
            from sentencepiece import SentencePieceProcessor

            self._hf = None
            self._sp = SentencePieceProcessor(model_file=str(sp_file))
            self.bos_id = self._sp.bos_id()
            self.eos_id = self._sp.eos_id()
        self.pad_id = PAD_ID
        self.epad_id = EPAD_ID
        self.use_bos = True
        self.use_eos = True
        self.max_length = max_length

    @property
    def is_discrete(self) -> bool:
        return True

    def token_to_id(self, token: str) -> int:
        tid = (
            self._hf.token_to_id(token)
            if self._hf is not None else self._sp.piece_to_id(token)
        )
        if tid is None:
            raise ValueError(f"unknown token {token!r}")
        return tid

    def _encode_raw(self, text: str):
        if self._hf is not None:
            enc = self._hf.encode(text)
            return list(enc.tokens), list(enc.ids)
        pieces = self._sp.encode_as_pieces(text)
        return pieces, [self._sp.piece_to_id(p) for p in pieces]

    def tokenize(self, text: str) -> List[int]:
        _, ids = self._encode_raw(text)
        if self.use_bos and self.bos_id is not None and (
            not ids or ids[0] != self.bos_id
        ):
            ids = [self.bos_id] + ids
        if self.use_eos and self.eos_id is not None and ids[-1] != self.eos_id:
            ids = ids + [self.eos_id]
        if self.max_length > 0:
            ids = ids[: self.max_length]
        return ids

    def decode(self, ids) -> str:
        ids = np.asarray(ids).reshape(-1).tolist()
        if self._hf is not None:
            return self._hf.decode(ids)
        return self._sp.decode(ids)

    # ------------------------------------------------------------------
    # Word-level alignment (timed-text tasks)
    # ------------------------------------------------------------------

    def word_alignment(self, tokens: Sequence[str], ids: Sequence[int]):
        """Group subwords into words via the "▁"/"Ġ" word-start markers."""
        out: List[Dict] = []
        word, subs = "", []
        for tok, tid in zip(tokens, ids):
            if tok.startswith("▁") or tok.startswith("Ġ"):
                if word:
                    out.append({"word": word, "tokens": subs})
                word, subs = tok[1:], [tid]
            else:
                word += tok
                subs.append(tid)
        if word:
            out.append({"word": word, "tokens": subs})
        return out

    def tokenize_segments(self, segments: Sequence[Dict]) -> List[Dict]:
        """Attach subword ids to each timed word of ASR-style segments."""
        words: List[Dict] = []
        for seg in segments:
            tokens, ids = self._encode_raw(seg["text"])
            if ids and ids[0] == self.bos_id:
                tokens, ids = tokens[1:], ids[1:]
            mapping = self.word_alignment(tokens, ids)
            for word, m in zip(seg["words"], mapping):
                word = dict(word)
                word["tokens"] = m["tokens"]
                words.append(word)
        return words

    def pad_tokens(
        self, word_list: Sequence[Dict], duration: float, frame_rate: float = 12.5
    ) -> np.ndarray:
        """Place each timed word's ids at its frame position in a
        ``<pad>``-initialised buffer, marking word onsets with ``<epad>``."""
        length = math.ceil(duration * frame_rate)
        out = np.full((length,), self.pad_id, np.int64)
        for word in word_list:
            if "start" not in word:
                continue
            start = round(word["start"] * frame_rate)
            if start == 0:
                start += 1
            if out[start - 1] == self.pad_id:
                out[start - 1] = self.epad_id
            for i, tid in enumerate(word["tokens"]):
                if start + i >= length:
                    break
                out[start + i] = tid
        return out
