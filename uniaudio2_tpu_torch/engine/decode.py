"""Autoregressive decode engine (port of `uniaudio2_tpu/engine/decode.py`).

The JAX package compiles the whole generation into one ``lax.while_loop``.
Here prompts are padded to bucket lengths, KV caches are sized to the
program's budget and updated in place (on the graph path kept across
requests, for at most ``KEEP_PROGRAMS`` programs), and the
per-frame state (feedback tokens, two-phase flags, output buffers, the
position) lives in device tensors that the frame step updates without
reading them back. On a card the frame step is a captured CUDA graph per
prefix level (`frame_graph.FrameGraph`), replayed frame by frame, with the
stop flag read once every ``frame_graph.STOP_EVERY`` frames; on the CPU the
same step runs eagerly. ``DecodeEngine(graph=False)`` keeps the eager
frame loop (`_frames`, one read of the stop flag per frame), the yardstick
the graph path is held to.

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

Batched serving (``generate_*_batch``: ragged prompts left-padded to one
bucket, per-row EOS and phase state, per-row seeds, CFG pairs), beam
search and n-gram-blocked text decoding (host-driven steps over a cache of
``max_seq_len`` slots) are the JAX engine's. Not ported: the cache
shardings of a multi-card mesh (``_shard_caches``, ROADMAP queue 1 item
16).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.engine.frame_graph import (
    PHASE_DROPPED, PHASE_REASON, PHASE_SEMANTIC, FrameGraph,
)
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.ops.kv_cache import reorder
from uniaudio2_tpu_torch.ops.sampling import RowKeys

Params = Dict[str, Any]

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048)
KEEP_PROGRAMS = 4   # frame graphs an engine keeps (least recently used go)


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
    the CFG pair) and `generate_text` (ASR, n-gram blocking) for one
    request, `generate_*_batch` for many, `generate_text_beam`. With
    ``graph`` (the default) the frame loop of `generate_text`,
    `generate_audio` and `generate_*_batch` runs through `FrameGraph`
    (captured CUDA graphs on a card); ``graph=False`` runs the eager
    loop."""

    def __init__(self, params: Params, cfg: UnifiedModelConfig, *,
                 max_frames: int = 500, cache_dtype=torch.bfloat16,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 attn_block: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_write: Optional[str] = None,
                 graph: bool = True):
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
        self.graph = graph
        self.last_steps = 0     # frames (host-driven: steps) of the last call
        self.last_frames_run = 0    # frames the device ran in it (graph
        # path: replays, including those after the last row's EOS, and
        # warm-up frames)
        self.last_policy = {}   # cache length and policies of that call
        # the graph path's programs, least recently used first, and the
        # caches they hold: (rows, cache_len, dtype) -> caches
        self.frame_graphs: "OrderedDict[tuple, FrameGraph]" = OrderedDict()
        self._kept = {}
        self.capture_seconds = 0.0  # warming up and capturing, all calls
        self._generator = None  # the shared stream the graphs sample from
        self.graph_pool = None  # one memory pool for all the graphs

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

    def _pack_left(self, items):
        """[(grid (S_i, 9), mask)] -> LEFT-padded (B, bucket, 9) tensors,
        the (B,) prompt lengths and the bucket of the longest."""
        par = self.cfg.tokens.parallel_number
        lengths = [g.shape[0] for g, _ in items]
        bucket = pick_bucket(max(lengths), self.buckets)
        g = np.zeros((len(items), bucket, par), np.int64)
        m = np.zeros((len(items), bucket, par), bool)
        for i, (grid, mask) in enumerate(items):
            g[i, bucket - grid.shape[0]:] = grid
            m[i, bucket - grid.shape[0]:] = mask
        return (torch.from_numpy(g).to(self.device),
                torch.from_numpy(m).to(self.device), np.asarray(lengths),
                bucket)

    def _left_padded(self, rows):
        """The batched path's inputs: the left-padded (B, bucket, 9) grid and
        mask, ``key_valid`` (B, cache_len), the bucket and the cache length
        (`min(max(max_seq_len, bucket + max_frames + 1), that rounded up to
        256)`, the JAX engine's)."""
        g, m, lengths, bucket = self._pack_left(rows)
        need = bucket + self.max_frames + 1
        cache_len = min(max(self.cfg.max_seq_len, need), -(-need // 256) * 256)
        return (g, m, left_pad_valid(lengths, bucket, cache_len, self.device),
                bucket, cache_len)

    def _caches(self, batch: int, cache_len: int, keep: bool = False):
        """Caches of ``batch`` rows and ``cache_len`` slots under the
        engine's policies, fresh, or with ``keep`` the kept ones of that
        shape (a captured graph holds their addresses; a prefill overwrites
        what a request reads); records the policies in ``last_policy``."""
        attn_block = resolve_attn_block(self.attn_block, cache_len)
        kv_dtype = resolve_kv_quant(self.kv_quant, cache_len, self.cache_dtype,
                                    batch=batch)
        self.last_policy = dict(cache_len=cache_len, kv_dtype=kv_dtype,
                                attn_block=attn_block, kv_write=self.kv_write)
        key = (batch, cache_len, kv_dtype)
        if keep and key in self._kept:
            return self._kept[key]
        caches = unified.init_caches(
            self.cfg, batch, dtype=kv_dtype, seq_len=cache_len,
            as_lists=self._cache_lists, device=self.device)
        if keep:
            self._kept[key] = caches
        return caches

    def _frame_graph(self, mode: str, caches, rows: int, *, per_row: bool,
                     batched: bool, temperature: float, topk: int,
                     use_cfg: bool, cfg_scale: float) -> FrameGraph:
        """The `FrameGraph` of one program (mode, rows, cache, policies,
        sampling arguments, stream kind), made on first use and kept; past
        ``KEEP_PROGRAMS`` the least recently used goes, with the caches no
        kept program holds."""
        p = self.last_policy
        key = (mode, rows, p["cache_len"], p["kv_dtype"], p["attn_block"],
               p["kv_write"], float(temperature), int(topk), bool(use_cfg),
               float(cfg_scale), per_row, batched)
        if key in self.frame_graphs:
            self.frame_graphs.move_to_end(key)
        else:
            if self.device.type == "cuda" and self.graph_pool is None:
                self.graph_pool = torch.cuda.graph_pool_handle()
            if not per_row and self._generator is None:
                self._generator = torch.Generator(device=self.device)
            self.frame_graphs[key] = FrameGraph(
                self.params, self.cfg, caches, mode=mode, rows=rows,
                max_frames=self.max_frames, attn_block=p["attn_block"],
                kv_write=self.kv_write, temperature=temperature, topk=topk,
                use_cfg=use_cfg, cfg_scale=cfg_scale,
                generator=None if per_row else self._generator,
                batched=batched, pool=self.graph_pool)
            while len(self.frame_graphs) > KEEP_PROGRAMS:
                self.frame_graphs.popitem(last=False)
            held = {id(f.caches) for f in self.frame_graphs.values()}
            self._kept = {k: c for k, c in self._kept.items()
                          if id(c) in held}
        return self.frame_graphs[key]

    def _decode(self, mode: str, caches, prefill, tokens, tmask,
                first_pos: int, limit: int, *, seed: int, seeds,
                key_valid=None, **sampling):
        """``prefill()`` then the frame loop (`FrameGraph`, or `_frames`
        with ``graph=False``) from ``tokens`` / ``tmask`` (B, 1, 9) at
        ``first_pos``; the rows share one stream seeded with ``seed``, or
        each samples from its own of ``seeds``. Returns text_out,
        audio_out, phase_out (host arrays) and the frames run."""
        rows = tokens.shape[0]
        if seeds is not None and len(seeds) != rows:
            raise ValueError(f"{len(seeds)} seeds for {rows} rows")
        if not self.graph:
            prefill()
            if seeds is not None:
                stream = RowKeys.from_seeds(seeds, self.device)
            else:
                stream = torch.Generator(device=self.device)
                stream.manual_seed(seed)
            out = self._frames(mode, caches, tokens, tmask, first_pos, limit,
                               stream, key_valid=key_valid, **sampling)
            self.last_frames_run = self.last_steps
            return out
        fg = self._frame_graph(mode, caches, rows, per_row=seeds is not None,
                               batched=key_valid is not None, **sampling)
        frames = min(self.max_frames, limit - first_pos)
        before = fg.capture_seconds
        fg.prepare(first_pos, frames)
        self.capture_seconds += fg.capture_seconds - before
        prefill()
        text, audio, phases, n, run = fg.run(
            tokens, tmask, first_pos, frames, seed=seed, key_valid=key_valid,
            keys=None if seeds is None
            else RowKeys.from_seeds(seeds, self.device).keys)
        self.last_steps, self.last_frames_run = n, run
        return text, audio, phases, n

    def _frames(self, mode: str, caches, tokens, tmask, first_pos: int,
                limit: int, stream, *, temperature: float, topk: int,
                use_cfg: bool, cfg_scale: float, key_valid=None):
        """The frame loop over B rows, the first frame fed ``tokens`` /
        ``tmask`` (B, 1, 9) at ``first_pos``, every row at the same
        position, until ``max_frames`` frames, position ``limit`` or every
        row's EOS. Per-row EOS, two-phase state and ``forbid_prefix``
        (rows of a CFG pair carry the same). ``stream`` is one generator,
        or `RowKeys` that each frame folds with its step. Returns text_out
        (B, F), audio_out (B, F, 8), phase_out (B, F) on the host and the
        frames run."""
        cfg, ts, dev = self.cfg, self.cfg.tokens, self.device
        ncb, max_frames, b = ts.num_codebooks, self.max_frames, tokens.shape[0]
        pos = torch.full((1,), first_pos, dtype=torch.int64, device=dev)
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        is_reason = torch.ones((b,), dtype=torch.bool, device=dev)
        forbid = torch.zeros((b,), dtype=torch.int64, device=dev)
        audio_out = torch.zeros((b, max_frames, ncb), dtype=torch.int64,
                                device=dev)
        phase_out = torch.zeros((b, max_frames), dtype=torch.int64, device=dev)
        text_out = torch.full((b, max_frames), -1, dtype=torch.int64,
                              device=dev)
        audio_fb = torch.zeros((b, 1, ts.parallel_number), dtype=torch.bool,
                               device=dev)
        audio_fb[..., :-1] = True
        text_fb = ~audio_fb
        sem_eos = ts.semantic_eos + ts.audio_reason_card
        step = 0
        with torch.no_grad():
            while step < max_frames and first_pos + step < limit:
                frame, caches = unified.decode_frame(
                    self.params, cfg, tokens, tmask, caches, pos,
                    stream.fold(step) if isinstance(stream, RowKeys)
                    else stream,
                    temperature=temperature, topk=topk,
                    forbid_prefix=forbid[:, None], use_cfg=use_cfg,
                    cfg_scale=cfg_scale, sample_text=mode == "text",
                    sample_audio=mode == "audio", key_valid=key_valid,
                    attn_block=self.last_policy["attn_block"],
                    kv_write=self.kv_write, host_pos=first_pos + step)
                text_tok, audio_toks = frame[:, 0], frame[:, 1:]
                if mode == "text":
                    eos_now = text_tok == ts.text_eos
                    text_out[:, step] = torch.where(finished | eos_now, -1,
                                                    text_tok)
                    finished = finished | eos_now
                    tokens = torch.zeros_like(tokens)
                    tokens[:, 0, -1] = text_tok
                    tmask = text_fb
                else:
                    stop = torch.all(audio_toks == sem_eos, dim=1)
                    switch = is_reason & torch.all(audio_toks == ts.reason_eos,
                                                   dim=1)
                    # the reference saves every frame but the switch and the
                    # stop frame (tts_task.py:264-273), and a finished row
                    # saves nothing more
                    save_now = ~switch & ~stop & ~finished
                    finished = finished | stop
                    is_reason = is_reason & ~switch
                    phase_out[:, step] = torch.where(
                        save_now,
                        torch.where(is_reason, PHASE_REASON, PHASE_SEMANTIC),
                        PHASE_DROPPED)
                    audio_out[:, step] = audio_toks
                    text_out[:, step] = text_tok
                    forbid = torch.where(switch, ts.audio_reason_card, forbid)
                    tokens = frame.roll(-1, dims=1)[:, None, :]
                    tmask = audio_fb
                pos += 1
                step += 1
                if bool(finished.all()):    # the loop's one read of the device
                    break
        self.last_steps = step
        return (text_out.cpu().numpy(), audio_out.cpu().numpy(),
                phase_out.cpu().numpy(), step)

    def _run(self, mode: str, grid, mask, *, temperature: float, topk: int,
             seed: int, use_cfg: bool = False, cfg_scale: float = 1.0,
             neg_grid=None, neg_mask=None):
        """Prefill + the frame loop of one request (and its CFG row):
        row 0's (text_out, audio_out, phase_out) and the frames run."""
        g, m, length, bucket = self._pad_grid(grid, mask, use_cfg, neg_grid,
                                              neg_mask)
        cache_len = min(self.cfg.max_seq_len,
                        -(-(bucket + self.max_frames) // 256) * 256)
        caches = self._caches(g.shape[0], cache_len, keep=self.graph)

        def prefill():
            with torch.no_grad():
                unified.prefill(self.params, self.cfg, g[:, :-1], m[:, :-1],
                                caches)

        last = length - 1
        text, audio, phases, n = self._decode(
            mode, caches, prefill, g[:, last:last + 1], m[:, last:last + 1],
            last, cache_len - 1, seed=seed, seeds=None,
            temperature=temperature, topk=topk, use_cfg=use_cfg,
            cfg_scale=cfg_scale)
        return text[0], audio[0], phases[0], n

    def _run_batched(self, mode: str, rows, *, temperature: float, topk: int,
                     seed: int, seeds=None, use_cfg: bool = False,
                     cfg_scale: float = 1.0):
        """B independent rows in one frame loop (the JAX engine's
        `_build_generate_batched`). Prompts are LEFT-padded to one bucket,
        so every row's last prompt token sits at slot ``bucket - 1`` and all
        rows decode at one position (RoPE is relative: the shift keeps each
        row's geometry); a per-row ``key_valid`` hides the pad slots in
        prefill and decode. With ``seeds`` (one per row) each row samples
        from its own `RowKeys` stream, else all rows share one generator
        seeded with ``seed``."""
        g, m, key_valid, bucket, cache_len = self._left_padded(rows)
        caches = self._caches(g.shape[0], cache_len, keep=self.graph)

        def prefill():
            with torch.no_grad():
                unified.prefill(self.params, self.cfg, g[:, :-1], m[:, :-1],
                                caches, key_valid=key_valid[:, :bucket - 1])

        return self._decode(mode, caches, prefill, g[:, -1:], m[:, -1:],
                            bucket - 1, cache_len - 2, seed=seed, seeds=seeds,
                            key_valid=key_valid, temperature=temperature,
                            topk=topk, use_cfg=use_cfg, cfg_scale=cfg_scale)

    def generate_text(self, grid: np.ndarray, mask: np.ndarray, *,
                      temperature: float = 0.9, topk: int = 1,
                      seed: int = 888, no_repeat_ngram: int = 0) -> np.ndarray:
        """Text-output decode (ASR / captioning / QA): the generated text
        ids, EOS excluded. With ``no_repeat_ngram`` > 0 the host-driven
        blocked path runs (reference `generate_asr_with_ngram_sampling`,
        `asr_task.py:329`)."""
        if no_repeat_ngram > 0:
            return self._generate_text_host(
                grid, mask, temperature=temperature, topk=topk, seed=seed,
                no_repeat_ngram=no_repeat_ngram)
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

    def generate_text_batch(self, items, *, temperature: float = 0.9,
                            topk: int = 1, seed: int = 888, seeds=None):
        """Decode B prompts ([(grid (S_i, 9), mask)]) concurrently (ASR over
        a directory): a list of 1-D token arrays (EOS excluded), input
        order. ``seeds`` (one per item) gives each row its own stream, so
        an item's tokens do not depend on what else is in the batch (within
        one bucket); without, the rows share one stream seeded by
        ``seed``."""
        text, _, _, n = self._run_batched("text", items, temperature=temperature,
                                          topk=topk, seed=seed, seeds=seeds)
        return [row[row >= 0] for row in text[:, :n]]

    def generate_audio_batch(self, items, *, temperature: float = 0.9,
                             topk: int = 200, seed: int = 888, seeds=None,
                             use_cfg: bool = False, cfg_scale: float = 1.0,
                             neg_items=None):
        """Two-phase audio decode over B prompts concurrently: a list of
        (reason (8, T1_i), semantic (8, T2_i)) per item. With ``use_cfg``,
        ``neg_items`` holds each item's negative prompt (reference
        `prepare_tts_task_for_cfg`, `tts_task.py:171-189`) and the rows are
        interleaved [cond_i, uncond_i]; under ``seeds`` a pair shares its
        item's seed and samples from the cond row's stream."""
        rows = items
        if use_cfg:
            if neg_items is None or len(neg_items) != len(items):
                raise ValueError("CFG needs one negative prompt per item")
            rows = []
            for (g, m), (ng, nm) in zip(items, neg_items):
                if ng.shape != g.shape:
                    raise ValueError(
                        "CFG negative prompt must have the same length as the "
                        "prompt (pad-substitution, tts_task.py:171-189)")
                rows.extend([(g, m), (ng, nm)])
        stride = 2 if use_cfg else 1
        if seeds is not None:
            if len(seeds) != len(items):
                raise ValueError(f"{len(seeds)} seeds for {len(items)} items")
            seeds = [s for s in seeds for _ in range(stride)]
        _, audio, phases, n = self._run_batched(
            "audio", rows, temperature=temperature, topk=topk, seed=seed,
            seeds=seeds, use_cfg=use_cfg, cfg_scale=cfg_scale)
        return [split_two_phase(audio[i * stride], phases[i * stride], n,
                                self.cfg.tokens.audio_reason_card)
                for i in range(len(items))]

    # Host-driven single-step decoding (n-gram blocking, beam search): the
    # host reads the lm_head logits of every step and chooses the tokens.
    # The reference's beam search calls a method that does not exist
    # (`asr_task.py:593`); this is the step-logits API it needed.

    def _host_prefill(self, grid, mask, batch: int):
        """``batch`` copies of one prompt, right-padded to its bucket, in
        caches of ``max_seq_len`` slots (whose policies "auto" resolves at
        that length, as JAX's `_get_host_step`), prefilled. Returns the
        caches, the padded tensors and the prompt length."""
        length = grid.shape[0]
        bucket = pick_bucket(length, self.buckets)
        g = np.zeros((batch, bucket, self.cfg.tokens.parallel_number), np.int64)
        m = np.zeros(g.shape, bool)
        g[:, :length], m[:, :length] = grid, mask
        g = torch.from_numpy(g).to(self.device)
        m = torch.from_numpy(m).to(self.device)
        caches = self._caches(batch, self.cfg.max_seq_len)
        self.last_steps = self.last_frames_run = 0
        with torch.no_grad():
            unified.prefill(self.params, self.cfg, g[:, :-1], m[:, :-1], caches)
        return caches, g, m, length

    def _host_step(self, tokens, tmask, caches, pos: int) -> torch.Tensor:
        """One decode step of (B, 1, 9) tokens at ``pos``: the (B, V) f32
        text logits. Counted in ``last_steps``."""
        self.last_steps += 1
        self.last_frames_run += 1
        with torch.no_grad():
            h, _ = unified.decode_hidden(
                self.params, self.cfg, tokens, tmask, caches, pos,
                attn_block=self.last_policy["attn_block"],
                kv_write=self.kv_write)
            return gpt.lm_head(self.params["backbone"], h, self.cfg.backbone)

    def _text_feedback(self, text_tokens):
        """(B,) text ids -> (B, 1, 9) tokens and the text-only mask."""
        b = len(text_tokens)
        par = self.cfg.tokens.parallel_number
        toks = torch.zeros((b, 1, par), dtype=torch.int64)
        toks[:, 0, -1] = torch.as_tensor(np.asarray(text_tokens, np.int64))
        m = torch.zeros((b, 1, par), dtype=torch.bool)
        m[:, :, -1] = True
        return toks.to(self.device), m.to(self.device)

    def _generate_text_host(self, grid, mask, *, temperature, topk, seed,
                            no_repeat_ngram) -> np.ndarray:
        """Text decode with n-gram blocking, sampled on the host with
        ``np.random.default_rng(seed)`` exactly as the JAX engine does, so
        even sampled tokens match it wherever the logits agree."""
        ts = self.cfg.tokens
        caches, g, m, length = self._host_prefill(grid, mask, 1)
        rng = np.random.default_rng(seed)
        out: list = []
        tokens, tmask = g[:, length - 1:length], m[:, length - 1:length]
        pos = length - 1
        for _ in range(self.max_frames):
            logits = self._host_step(tokens, tmask, caches, pos)
            lg = logits[0].cpu().numpy().astype(np.float64) / max(
                temperature, 1e-6)
            if no_repeat_ngram > 1 and len(out) >= no_repeat_ngram - 1:
                banned = _banned_ngram_tokens(out, no_repeat_ngram)
                lg[list(banned)] = -np.inf
            if topk > 1:
                kth = np.partition(lg, -topk)[-topk]
                lg[lg < kth] = -np.inf
                tok = int(np.argmax(lg + rng.gumbel(size=lg.shape)))
            else:
                tok = int(np.argmax(lg))
            if tok == ts.text_eos:
                break
            out.append(tok)
            tokens, tmask = self._text_feedback([tok])
            pos += 1
            if pos >= self.cfg.max_seq_len - 1:
                break
        return np.asarray(out, np.int64)

    def generate_text_beam(self, grid: np.ndarray, mask: np.ndarray, *,
                           beam_size: int = 4, length_penalty: float = 1.0,
                           max_steps: Optional[int] = None) -> np.ndarray:
        """Beam search over the text stream (the working replacement for the
        reference's broken `generate_asr_beam_search`, `asr_task.py:438-596`;
        length-penalised scoring per `:523`). The beams' cache rows are
        gathered in place after every step (`kv_cache.reorder`)."""
        ts = self.cfg.tokens
        caches, g, m, length = self._host_prefill(grid, mask, beam_size)
        scores = np.full((beam_size,), -np.inf)
        scores[0] = 0.0                     # all beams identical at step 0
        seqs: list = [[] for _ in range(beam_size)]
        finished: list = []                 # (score, seq)
        tokens, tmask = g[:, length - 1:length], m[:, length - 1:length]
        pos = length - 1
        for _ in range(max_steps or self.max_frames):
            logits = self._host_step(tokens, tmask, caches, pos)
            logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
            flat = (scores[:, None] + logp).reshape(-1)
            top = np.argpartition(flat, -beam_size)[-beam_size:]
            top = top[np.argsort(flat[top])[::-1]]
            v = logp.shape[-1]
            new_seqs, new_scores, order, next_toks = [], [], [], []
            for idx in top:
                b_idx, tok = int(idx // v), int(idx % v)
                cand_score = float(flat[idx])
                if tok == ts.text_eos:
                    lp = max(len(seqs[b_idx]), 1) ** length_penalty
                    finished.append((cand_score / lp, seqs[b_idx]))
                    continue
                new_seqs.append(seqs[b_idx] + [tok])
                new_scores.append(cand_score)
                order.append(b_idx)
                next_toks.append(tok)
            if not new_seqs:
                break
            while len(new_seqs) < beam_size:  # refill slots with the worst beam
                new_seqs.append(new_seqs[-1])
                new_scores.append(-np.inf)
                order.append(order[-1])
                next_toks.append(next_toks[-1])
            seqs, scores = new_seqs, np.asarray(new_scores)
            reorder(caches, torch.as_tensor(order, device=self.device))
            tokens, tmask = self._text_feedback(next_toks)
            pos += 1
            if pos >= self.cfg.max_seq_len - 1 or len(finished) >= beam_size:
                break
        if not finished:
            finished = [(s / max(len(q), 1) ** length_penalty, q)
                        for s, q in zip(scores, seqs)]
        return np.asarray(max(finished, key=lambda x: x[0])[1], np.int64)


def left_pad_valid(lengths, bucket: int, cache_len: int,
                   device) -> torch.Tensor:
    """(B, cache_len) bool: row b may attend slot s iff s >= bucket -
    lengths[b]; its left-pad slots stay invalid for the whole decode."""
    pad = torch.as_tensor(bucket - np.asarray(lengths), device=device)
    return torch.arange(cache_len, device=device)[None, :] >= pad[:, None]


def _banned_ngram_tokens(history, n: int):
    """Next tokens that would complete an already-seen n-gram."""
    banned = set()
    prefix = tuple(history[-(n - 1):])
    for i in range(len(history) - n + 1):
        if tuple(history[i:i + n - 1]) == prefix:
            banned.add(history[i + n - 1])
    return banned


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
