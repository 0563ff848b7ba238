"""Per-task generation runners (port of `uniaudio2_tpu/engine/generators.py`).

The reference has one Generator class per task (`evaluation/*.py`), all
with one skeleton: build a conditioning grid from the task format, prefill,
run the frame loop, split the output. Here that skeleton is three pieces:
`engine/tasks.py` (grid construction), `engine/decode.py` (the frame loop)
and this module's `TaskRunner`, which binds the 14 public tasks to their
conditioning keys and output modes:

understanding (audio -> text): ASR, Yue_ASR, lyric_recognition,
    audio_caption, music_caption, audio_understanding, speech_s2t
generation (text/audio -> audio): TTS, Yue_TTS, TTA, TTM, LTS, InstructTTS,
    speech_s2s (+ speech_edit / speech_ss formats)

Prompt selection matches `_get_prompt_tensor`
(`multi_task_inference.py:75-97`): a random choice from the per-task
prompt list, "\n\n" suffix before tokenization. Host-side: the runner hands
numpy grids to the engine and gets numpy tokens back.
"""

from __future__ import annotations

import json
import random
from typing import Mapping, Optional, Tuple

import numpy as np

from uniaudio2_tpu_torch.config import TokenSpace
from uniaudio2_tpu_torch.engine import tasks as taskmod
from uniaudio2_tpu_torch.engine.decode import DecodeEngine

UNDERSTANDING_TASKS = [
    "ASR", "Yue_ASR", "lyric_recognition", "audio_caption", "music_caption",
    "audio_understanding", "speech_s2t",
]
GENERATION_TASKS = [
    "TTS", "Yue_TTS", "TTA", "TTM", "LTS", "InstructTTS", "speech_s2s",
]
TASK_PROMPT_SUFFIX = "\n\n"

# task -> (format name, conditioning data keys mapping from runner kwargs)
_TEXT_OUT_TASKS = {
    "asr": "ASR",
    "yue_asr": "Yue_ASR",
    "lyric_recognition": "lyric_recognition",
    "audio_caption": "audio_caption",
    "music_caption": "music_caption",
    "speech_s2t": "speech_s2t",
    "audio_understanding": "audio_understanding",
}
_AUDIO_OUT_TASKS = {
    "tts": "TTS",
    "yue_tts": "Yue_TTS",
    "tta": "TTA",
    "ttm": "TTM",
    "lts": "LTS",
    "instruct_tts": "InstructTTS",
    "instructtts": "InstructTTS",
    "speech_s2s": "speech_s2s",
    "speech_edit": "speech_edit",
    "speech_ss": "speech_ss",
    "speech_denoise": "speech_denoise",
    "music_ss": "music_ss",
}


def prompt_key_for_task(task: str) -> str:
    """--task string -> prompt-json key (reference `_prompt_key_from_task`)."""
    t = task.strip().lower()
    special = {
        "yue_tts": "Yue_TTS", "yue_asr": "Yue_ASR",
        "instruct_tts": "InstructTTS", "instructtts": "InstructTTS",
    }
    if t in special:
        return special[t]
    if t in ("asr", "tts", "tta", "ttm", "lts"):
        return t.upper()
    return t


def select_prompt(
    task: str,
    *,
    prompt_text: Optional[str] = None,
    prompt_json: Optional[str] = None,
    rng: Optional[random.Random] = None,
) -> str:
    """Pick the instruction text for a task (random paraphrase from the
    prompt bank, reference `multi_task_inference.py:75-97`)."""
    if prompt_text and prompt_text.strip():
        return prompt_text.strip()
    if not prompt_json:
        raise ValueError("provide prompt_text or prompt_json")
    with open(prompt_json, encoding="utf-8") as f:
        bank = json.load(f)
    key = prompt_key_for_task(task)
    if key not in bank:
        key = task if task in bank else task.upper()
    if key not in bank:
        key = next(iter(bank))
    choices = bank[key]
    if not choices:
        raise ValueError(f"no prompts for task {key}")
    return (rng or random).choice(choices)


class TaskRunner:
    """Binds a DecodeEngine + text tokenizer to the task surface."""

    def __init__(self, engine: DecodeEngine, text_tokenizer):
        self.engine = engine
        self.tok = text_tokenizer
        self.ts: TokenSpace = engine.cfg.tokens

    # ------------------------------------------------------------------
    def _prompt_ids(self, prompt: str) -> np.ndarray:
        return np.asarray(
            self.tok.tokenize(prompt.strip() + TASK_PROMPT_SUFFIX), np.int64
        )

    def _condition(self, task_key: str, prompt: str, d: Mapping[str, np.ndarray]):
        keys, types = taskmod.condition_prefix(task_key)
        ids = self._prompt_ids(prompt)
        grid, mask = taskmod.build_condition_grid(ids, d, keys, types, self.ts)
        return grid, mask, (ids, d, keys, types)

    # ------------------------------------------------------------------
    # Understanding (text output)
    # ------------------------------------------------------------------

    def run_text_task(
        self,
        task: str,
        prompt: str,
        d: Mapping[str, np.ndarray],
        *,
        temperature: float = 0.9,
        topk: int = 1,
        seed: int = 888,
        decode_type: str = "greedy",
        max_repeat_ngram: int = 0,
    ) -> str:
        """Audio -> text tasks. ``d`` carries the conditioning arrays keyed by
        the task format (reason_seq/semantic_seq (T, 8), question ids, ...)."""
        key = _TEXT_OUT_TASKS[task.strip().lower()]
        grid, mask, _ = self._condition(key, prompt, d)
        if decode_type == "greedy":
            topk = 1
        toks = self.engine.generate_text(
            grid, mask, temperature=temperature, topk=topk, seed=seed,
            no_repeat_ngram=max_repeat_ngram if decode_type == "ngram" else 0,
        )
        return self.tok.decode(toks)

    def asr(self, prompt, reason, semantic, **kw) -> str:
        return self.run_text_task(
            "asr", prompt, {"reason_seq": reason, "semantic_seq": semantic}, **kw
        )

    def caption(self, prompt, reason, semantic, *, music=False, **kw) -> str:
        task = "music_caption" if music else "audio_caption"
        return self.run_text_task(
            task, prompt, {"reason_seq": reason, "semantic_seq": semantic}, **kw
        )

    def audio_question(self, prompt, question_ids, reason, semantic, **kw) -> str:
        """audio_understanding: question + audio -> answer
        (reference `audio_understanding.py:284`)."""
        return self.run_text_task(
            "audio_understanding", prompt,
            {"text_seq_question": question_ids, "reason_seq": reason,
             "semantic_seq": semantic}, **kw,
        )

    def speech_s2t(self, prompt, reason, semantic, **kw) -> str:
        return self.run_text_task(
            "speech_s2t", prompt,
            {"reason_seq": reason, "semantic_seq": semantic}, **kw,
        )

    # ------------------------------------------------------------------
    # Generation (two-phase audio output)
    # ------------------------------------------------------------------

    def run_audio_task(
        self,
        task: str,
        prompt: str,
        d: Mapping[str, np.ndarray],
        *,
        temperature: float = 0.9,
        topk: int = 200,
        seed: int = 888,
        use_cfg: bool = False,
        cfg_scale: float = 1.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (reason (8, T1), semantic (8, T2))."""
        key = _AUDIO_OUT_TASKS[task.strip().lower()]
        grid, mask, (ids, d_, keys, types) = self._condition(key, prompt, d)
        neg_grid = neg_mask = None
        if use_cfg:
            neg_grid, neg_mask = taskmod.build_cfg_negative_grid(
                ids, d_, keys, types, self.ts
            )
        return self.engine.generate_audio(
            grid, mask, temperature=temperature, topk=topk, seed=seed,
            use_cfg=use_cfg, cfg_scale=cfg_scale,
            neg_grid=neg_grid, neg_mask=neg_mask,
        )

    def tts(self, prompt, text_ids, **kw):
        return self.run_audio_task(
            "tts", prompt, {"transcription_seq": text_ids}, **kw
        )

    def tta(self, prompt, caption_ids, **kw):
        return self.run_audio_task("tta", prompt, {"caption_seq": caption_ids}, **kw)

    def ttm(self, prompt, caption_ids, **kw):
        return self.run_audio_task("ttm", prompt, {"caption_seq": caption_ids}, **kw)

    def lts(self, prompt, lyric_ids, **kw):
        return self.run_audio_task("lts", prompt, {"lyric_seq": lyric_ids}, **kw)

    def instruct_tts(self, prompt, caption_ids, text_ids, **kw):
        return self.run_audio_task(
            "instruct_tts", prompt,
            {"caption_seq": caption_ids, "transcription_seq": text_ids}, **kw,
        )

    def speech_s2s(self, prompt, reason, semantic, **kw):
        return self.run_audio_task(
            "speech_s2s", prompt,
            {"reason_seq_1": reason, "semantic_seq_1": semantic}, **kw,
        )

    def speech_edit(self, prompt, instruction_ids, reason, semantic, **kw):
        return self.run_audio_task(
            "speech_edit", prompt,
            {"text_seq": instruction_ids, "reason_seq_1": reason,
             "semantic_seq_1": semantic}, **kw,
        )
