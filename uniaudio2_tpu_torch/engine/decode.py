"""Autoregressive decode engine (port of `uniaudio2_tpu/engine/decode.py`).

The JAX package compiles the whole generation into one ``lax.while_loop``.
Here it is a Python frame loop around a static-shape frame step: prompts
are padded to bucket lengths, KV caches are sized to the program's budget
and updated in place, and the per-frame state (feedback tokens, two-phase
flags, output buffers, the position) lives in device tensors that the step
updates without reading them back. The loop reads one flag per frame, the
stop condition, after the step; the step itself never synchronises with
the host, so a later change can capture it in a CUDA graph.

Output protocol (two-phase audio): as in the JAX package, every frame goes
into a (max_frames, 8) buffer with a phase tag, and `split_two_phase`
reproduces the reference's list semantics (`tts_task.py:261-284`).

Cache policies, as the JAX engine resolves them per program: the int8 KV
cache (``kv_quant``, env ``UA2_KV_QUANT``), prefix-bounded attention reads
(``attn_block``, env ``UA2_ATTN_BLOCK``) and deferred KV writes
(``kv_write``, env ``UA2_KV_WRITE``). The three environment variables are
the JAX engine's serving interface; they pick a policy, never a kernel or
its twin. The prefix level of each frame is picked from the host's own
count of the position (``last + step``), never read back from the device.

Not ported yet (ROADMAP queue 1 item 7): batched ``generate_*_batch``,
beam search and the host-driven n-gram blocking path.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.models import unified

Params = Dict[str, Any]

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048)

PHASE_DROPPED = 0
PHASE_REASON = 1
PHASE_SEMANTIC = 2


def resolve_kv_quant(mode: Optional[str], cache_len: int, cache_dtype,
                     batch: int = 1):
    """The int8-KV-cache switch, with the JAX package's policy: "on"/"1"/
    "int8" force int8, "off"/"0" keep ``cache_dtype``, "auto"/None (env
    ``UA2_KV_QUANT``, default auto) chooses int8 when ``batch >= 8`` or
    ``cache_len >= 512``."""
    if mode is None:
        mode = os.environ.get("UA2_KV_QUANT", "auto")
    mode = str(mode).strip().lower()
    aliases = {"0": "off", "off": "off", "1": "on", "on": "on",
               "int8": "on", "auto": "auto"}
    if mode not in aliases:
        raise ValueError(
            f"UA2_KV_QUANT={mode!r}: expected on/1/int8, off/0, or auto")
    mode = aliases[mode]
    if mode == "on" or (mode == "auto"
                        and (cache_len >= 512 or batch >= 8)
                        and cache_dtype != torch.int8):
        return torch.int8
    return cache_dtype


def resolve_kv_write(mode: Optional[str]) -> str:
    """"inline" (default) or "deferred"; None reads ``UA2_KV_WRITE``."""
    if mode is None:
        mode = os.environ.get("UA2_KV_WRITE", "inline")
    mode = str(mode).strip().lower()
    if mode not in ("inline", "deferred"):
        raise ValueError(
            f"UA2_KV_WRITE={mode!r}: expected inline or deferred")
    return mode


def resolve_attn_block(attn_block: Optional[int], cache_len: int) -> int:
    """``attn_block < 0`` (or None) is AUTO: block 128 when the cache budget
    is >= 512 slots, off below."""
    if attn_block is None:
        attn_block = -1
    if attn_block < 0:
        return 128 if cache_len >= 512 else 0
    return attn_block


def pick_bucket(length: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket {buckets[-1]} "
        f"(the reference caps its KV cache at 2048, model_new.py:560)")


class DecodeEngine:
    """Host entry points for one model: `generate_audio` (two-phase TTS and
    the CFG pair) and `generate_text` (ASR), batch 1."""

    def __init__(self, params: Params, cfg: UnifiedModelConfig, *,
                 max_frames: int = 500, cache_dtype=torch.bfloat16,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 attn_block: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_write: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self.max_frames = max_frames
        self.cache_dtype = cache_dtype
        if attn_block is None:
            env = os.environ.get("UA2_ATTN_BLOCK", "auto")
            attn_block = -1 if env == "auto" else int(env)
        self.attn_block = int(attn_block)
        self.kv_quant = kv_quant
        self.kv_write = resolve_kv_write(kv_write)
        self.buckets = tuple(b for b in buckets if b <= cfg.max_seq_len) or (
            cfg.max_seq_len,)
        self.device = params["audio_embeddings"].device
        self._cache_lists = isinstance(
            params.get("backbone", {}).get("layers"), list
        ) and self.kv_write != "deferred"
        self.last_steps = 0     # frames run by the last generate_* call
        self.last_policy = {}   # cache length and policies of that call

    def _pad_grid(self, grid, mask, use_cfg, neg_grid, neg_mask):
        length = grid.shape[0]
        bucket = pick_bucket(length, self.buckets)
        par = self.cfg.tokens.parallel_number
        batch = 2 if use_cfg else 1
        g = np.zeros((batch, bucket, par), np.int64)
        m = np.zeros((batch, bucket, par), bool)
        g[0, :length] = grid
        m[0, :length] = mask
        if use_cfg:
            if neg_grid is None or neg_grid.shape[0] != length:
                raise ValueError(
                    "CFG negative prompt must have the same length as the "
                    "prompt (the reference builds it by pad-substitution, "
                    "tts_task.py:171-189)")
            g[1, :length] = neg_grid
            m[1, :length] = neg_mask
        return (torch.from_numpy(g).to(self.device),
                torch.from_numpy(m).to(self.device), length, bucket)

    def _run(self, mode: str, grid, mask, *, temperature: float, topk: int,
             seed: int, use_cfg: bool = False, cfg_scale: float = 1.0,
             neg_grid=None, neg_mask=None):
        """Prefill + the frame loop. Returns (text_out, audio_out,
        phase_out) as numpy arrays and the number of frames run."""
        cfg, ts, dev = self.cfg, self.cfg.tokens, self.device
        ncb = ts.num_codebooks
        g, m, length, bucket = self._pad_grid(grid, mask, use_cfg, neg_grid,
                                              neg_mask)
        batch = g.shape[0]
        max_frames = self.max_frames
        cache_len = min(cfg.max_seq_len,
                        -(-(bucket + max_frames) // 256) * 256)
        attn_block = resolve_attn_block(self.attn_block, cache_len)
        cache_dtype = resolve_kv_quant(self.kv_quant, cache_len,
                                       self.cache_dtype, batch=batch)
        self.last_policy = dict(cache_len=cache_len, kv_dtype=cache_dtype,
                                attn_block=attn_block, kv_write=self.kv_write)
        caches = unified.init_caches(cfg, batch, dtype=cache_dtype,
                                     seq_len=cache_len,
                                     as_lists=self._cache_lists, device=dev)
        caches = unified.prefill(self.params, cfg, g[:, :-1], m[:, :-1], caches)
        last = length - 1
        tokens, tmask = g[:, last:last + 1], m[:, last:last + 1]
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        pos = torch.full((1,), last, dtype=torch.int64, device=dev)
        is_reason = torch.ones((), dtype=torch.bool, device=dev)
        forbid = torch.zeros((), dtype=torch.int64, device=dev)
        audio_out = torch.zeros((max_frames, ncb), dtype=torch.int64, device=dev)
        phase_out = torch.zeros((max_frames,), dtype=torch.int64, device=dev)
        text_out = torch.full((max_frames,), -1, dtype=torch.int64, device=dev)
        audio_fb = torch.zeros((batch, 1, ts.parallel_number), dtype=torch.bool,
                               device=dev)
        audio_fb[..., :-1] = True
        text_fb = ~audio_fb
        sem_eos = ts.semantic_eos + ts.audio_reason_card
        step = 0
        with torch.no_grad():
            while step < max_frames and last + step < cache_len - 1:
                frame, caches = unified.decode_frame(
                    self.params, cfg, tokens, tmask, caches, pos, generator,
                    temperature=temperature, topk=topk, forbid_prefix=forbid,
                    use_cfg=use_cfg, cfg_scale=cfg_scale,
                    sample_text=mode == "text", sample_audio=mode == "audio",
                    attn_block=attn_block, kv_write=self.kv_write,
                    host_pos=last + step)
                text_tok = frame[0, 0]          # row 0 = conditioned
                audio_toks = frame[0, 1:]
                if mode == "text":
                    finished = text_tok == ts.text_eos
                    text_out[step] = torch.where(finished, -1, text_tok)
                    tokens = torch.zeros_like(tokens)
                    tokens[:, 0, -1] = text_tok
                    tmask = text_fb
                else:
                    finished = torch.all(audio_toks == sem_eos)
                    switch = is_reason & torch.all(audio_toks == ts.reason_eos)
                    save_now = ~switch & ~finished
                    is_reason = is_reason & ~switch
                    phase = torch.where(
                        save_now,
                        torch.where(is_reason, PHASE_REASON, PHASE_SEMANTIC),
                        PHASE_DROPPED)
                    audio_out[step] = audio_toks
                    phase_out[step] = phase
                    text_out[step] = text_tok
                    forbid = torch.where(switch, ts.audio_reason_card, forbid)
                    tokens = torch.cat(
                        [audio_toks.expand(batch, ncb),
                         text_tok.expand(batch)[:, None]], dim=1)[:, None, :]
                    tmask = audio_fb
                pos += 1
                step += 1
                if bool(finished):      # the loop's one read of the device
                    break
        self.last_steps = step
        return (text_out.cpu().numpy(), audio_out.cpu().numpy(),
                phase_out.cpu().numpy(), step)

    def generate_text(self, grid: np.ndarray, mask: np.ndarray, *,
                      temperature: float = 0.9, topk: int = 1,
                      seed: int = 888, no_repeat_ngram: int = 0) -> np.ndarray:
        """Text-output decode (ASR / captioning / QA): the generated text
        ids, EOS excluded."""
        if no_repeat_ngram > 0:
            raise NotImplementedError(
                "n-gram blocked text decoding is not ported yet "
                "(ROADMAP queue 1 item 7)")
        text, _, _, n = self._run("text", grid, mask, temperature=temperature,
                                  topk=topk, seed=seed)
        toks = text[:n]
        return toks[toks >= 0]

    def generate_audio(self, grid: np.ndarray, mask: np.ndarray, *,
                       temperature: float = 0.9, topk: int = 200,
                       seed: int = 888, use_cfg: bool = False,
                       cfg_scale: float = 1.0,
                       neg_grid: Optional[np.ndarray] = None,
                       neg_mask: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Two-phase audio decode (TTS/TTA/TTM/LTS/s2s) -> (reason (8, T1),
        semantic (8, T2))."""
        _, audio, phases, n = self._run(
            "audio", grid, mask, temperature=temperature, topk=topk, seed=seed,
            use_cfg=use_cfg, cfg_scale=cfg_scale, neg_grid=neg_grid,
            neg_mask=neg_mask)
        return split_two_phase(audio, phases, n, self.cfg.tokens.audio_reason_card)

    def generate_text_batch(self, items, **kwargs):
        raise NotImplementedError(
            "batched decoding is not ported yet (ROADMAP queue 1 item 7)")

    def generate_audio_batch(self, items, **kwargs):
        raise NotImplementedError(
            "batched decoding is not ported yet (ROADMAP queue 1 item 7)")

    def generate_text_beam(self, grid, mask, **kwargs):
        raise NotImplementedError(
            "beam search is not ported yet (ROADMAP queue 1 item 7)")


def split_two_phase(audio_out: np.ndarray, phase_out: np.ndarray,
                    n_steps: int, reason_card: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's phase split (`tts_task.py:261-285`): saved reasoning
    / semantic frames, the first frame of each phase dropped, the reasoning
    offset subtracted from semantic codes, (8, T) layouts."""
    phases = phase_out[:n_steps]
    frames = audio_out[:n_steps]
    reason = frames[phases == PHASE_REASON][1:]
    semantic = frames[phases == PHASE_SEMANTIC][1:] - reason_card
    return reason.T.astype(np.int64), semantic.T.astype(np.int64)
