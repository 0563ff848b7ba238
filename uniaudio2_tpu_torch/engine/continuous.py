"""Continuous batching: slot-level admission into a running batched decode
(port of `uniaudio2_tpu/engine/continuous.py`).

The static batched path (`DecodeEngine.generate_*_batch`) runs one fixed
request set to completion, so short rows idle while the longest finishes.
This scheduler admits requests at iteration level instead:

* the decode runs in SEGMENTS of K frames over a B-row batch with per-row
  two-phase / EOS / budget state; the ONLINE scheduler picks each
  boundary's K from a LADDER (short on a segment that carries an
  admission, full otherwise) and, when asked, runs a row-free-REACTIVE
  segment that stops the frame a row completes while a request waits
  behind a full batch;
* a segment starts with the refills of the rows it admits: each writes one
  queued prompt into one row's cache so that the prompt ENDS at the
  window's current position (RoPE is relative, so the geometry is the one
  of a batch start) and moves the row's ``valid_from`` mask;
* once the queue is empty one DRAIN decodes until every row has hit EOS,
  its frame budget or the cache end;
* when every row is free and the head of the queue no longer fits the
  cache budget, the shared position resets to the prompt bucket; with
  ``windows=2`` a budget-blocked arrival admits into a second (overlap)
  cache window while the first one's rows finish.

Every frame's outputs go into one (B, K, ncb + 3) slab [text, audio x ncb,
phase, done], copied to the host once per program run.

On a CUDA device each frame is the replay of a captured frame step (one
graph per prefix level, the level picked by the host from its mirror of
the position, as `engine/frame_graph.py` does); the refills run eagerly
between replays, at the segment boundary, writing in place into the
buffers the graphs read. The drain reads its stop flag every
`STOP_EVERY` replays, the reactive segment after every replay. A capture
that fails raises; nothing falls back to an eager step. On the CPU the
same step runs eagerly, so the CPU tests hold the captured body to JAX.

The step advances the position on every frame of a segment (as JAX's
segment does), and in a drain or a reactive segment only while a row is
live, so replays past the last row's completion change nothing and the
host reads how many frames ran from a device counter. Sampling draws from
the window's `RowKeys` folded with a device frame counter: the stream
advances per frame, not per segment, so for a fixed admission schedule
the segment lengths do not change sampled tokens. Tokens match JAX's only
under ``topk=1`` (the two frameworks draw different numbers).

Correctness invariant (tested): a request admitted into a running batch
gives the greedy tokens of the same request decoded alone.

CFG (``use_cfg=True``, audio mode): rows are [cond, uncond] pairs; a
request's prompt goes into row 2p and its negative prompt into row 2p+1 at
the same refill, the pair's logits are mixed in `unified.decode_frame` and
both rows receive the sampled frame.
"""

from __future__ import annotations

import os
import queue
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.engine.decode import (
    PHASE_DROPPED, PHASE_REASON, PHASE_SEMANTIC, resolve_attn_block,
    resolve_kv_quant, resolve_kv_write, split_two_phase,
)
from uniaudio2_tpu_torch.engine.frame_graph import STOP_EVERY
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.models.unified import UnifiedCaches
from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.attention import pick_level
from uniaudio2_tpu_torch.ops.kv_cache import KVCache, QuantKV
from uniaudio2_tpu_torch.ops.sampling import RowKeys

Params = Dict[str, Any]


class SlotState(NamedTuple):
    """One window's device state: static tensors that the frame step and
    the refills update in place."""

    pos: torch.Tensor            # (1,) int64: next decode position (shared)
    active: torch.Tensor         # (B,) bool: the row holds a live request
    frame_tokens: torch.Tensor   # (B, 1, 9) int64
    frame_mask: torch.Tensor     # (B, 1, 9) bool
    is_reason: torch.Tensor      # (B,) bool
    forbid_prefix: torch.Tensor  # (B,) int64
    valid_from: torch.Tensor     # (B,) int64: first valid cache slot per row
    stop_at: torch.Tensor        # (B,) int64: force-finish position (budget)
    keys: torch.Tensor           # (B,) int64: the window's RowKeys
    frame: torch.Tensor          # (1,) int64: frames run (the stream's fold)
    caches: UnifiedCaches


def _row_entry(e, row: int):
    """Row ``row`` of one cache entry, as a view: the batch axis is
    ``ndim - 4`` of values (stacked (L, B, G, S, hd) or per-layer
    (B, G, S, hd)) and ``ndim - 3`` of `QuantKV` scales."""
    if isinstance(e, QuantKV):
        return QuantKV(e.q.narrow(e.q.ndim - 4, row, 1),
                       e.s.narrow(e.s.ndim - 3, row, 1))
    return e.narrow(e.ndim - 4, row, 1)


def row_caches(caches: UnifiedCaches, row: int) -> UnifiedCaches:
    """Views of one batch row of every cache leaf, in the stacked or the
    list layout: a write through them lands in ``caches``."""
    def one(c: KVCache) -> KVCache:
        if isinstance(c.k, list):
            return KVCache([_row_entry(e, row) for e in c.k],
                           [_row_entry(e, row) for e in c.v])
        return KVCache(_row_entry(c.k, row), _row_entry(c.v, row))
    return UnifiedCaches(*(one(c) for c in caches))


def _cache_tensors(caches):
    for c in caches:
        for field_ in (c.k, c.v):
            for e in field_ if isinstance(field_, list) else [field_]:
                yield from (e if isinstance(e, QuantKV) else (e,))


def _refill_one(params: Params, cfg: UnifiedModelConfig, s: SlotState,
                row: int, grid: torch.Tensor, grid_mask: torch.Tensor,
                length: int, max_frames: int, bucket: int, pos: int,
                attn_block: int = 0) -> None:
    """Write one queued request's left-padded (bucket, 9) prompt into
    ``row``, in place. Grid slot i maps to position start + i with the LAST
    real token (slot bucket - 1) at ``pos``, the window's position: it is
    the row's first frame input there, as in the static batched start.
    Slots [start, pos) are written by one bucket - 1 token decode step of
    the row's cache views; ``key_valid`` hides the pad slots (causal
    masking keeps them from the real ones) and, after, every slot before
    the prompt."""
    start = pos - (bucket - 1)
    cache_len = s.caches.backbone.max_seq
    valid_from = pos - length + 1
    key_valid = (torch.arange(cache_len, device=grid.device)
                 >= valid_from)[None, :]
    unified.decode_hidden(params, cfg, grid[None, :-1], grid_mask[None, :-1],
                          row_caches(s.caches, row), start,
                          key_valid=key_valid, attn_block=attn_block)
    s.active[row] = True
    s.frame_tokens[row] = grid[-1:]
    s.frame_mask[row] = grid_mask[-1:]
    s.is_reason[row] = True
    s.forbid_prefix[row] = 0
    s.valid_from[row] = valid_from
    s.stop_at[row] = pos + max_frames


@dataclass
class _Slot:
    request_id: int = -1
    max_frames: int = 0
    text: List[int] = field(default_factory=list)
    audio: List[np.ndarray] = field(default_factory=list)
    phase: List[int] = field(default_factory=list)


class _Window:
    """One shared-position cache window: its device state, the frame
    step's other static buffers (the output slab and its write index, the
    program flags, the local decoder's cache), its graphs by prefix level
    and the host's mirrors. The engine runs one window; with ``windows=2``
    a second one (made once, then reused) takes arrivals while the first
    drains."""

    def __init__(self, state: SlotState, slab_frames: int, n_slots: int,
                 local, device):
        b = state.active.shape[0]
        self.state = state
        self.pos = 0                       # host mirror of state.pos
        self.slots = [_Slot() for _ in range(n_slots)]
        self.slab = torch.zeros((b, slab_frames, state.frame_tokens.shape[-1]
                                 + 2), dtype=torch.int64, device=device)
        self.k = torch.zeros((1,), dtype=torch.int64, device=device)
        # a segment advances on every frame; a drain / reactive segment
        # only while a row is live; a warm-up frame before a capture not
        # at all (``enable`` False)
        self.always = torch.zeros((1,), dtype=torch.bool, device=device)
        self.enable = torch.ones((1,), dtype=torch.bool, device=device)
        self.freed = torch.zeros((1,), dtype=torch.bool, device=device)
        self.local = local
        self.graphs: Dict[Any, tuple] = {}   # level -> (CUDAGraph, counts)


@dataclass
class _Request:
    rid: int
    grid: np.ndarray
    mask: np.ndarray
    max_frames: int
    neg_grid: Optional[np.ndarray] = None
    neg_mask: Optional[np.ndarray] = None


class ContinuousEngine:
    """Host-side iteration-level scheduler over the frame step.

    Usage:
        eng = ContinuousEngine(params, cfg, mode="text", rows=4)
        rid = eng.submit(grid, mask)            # from engine/tasks.py
        results = eng.run_until_drained()       # {rid: tokens | (r, s)}
    """

    def __init__(self, params: Params, cfg: UnifiedModelConfig, *,
                 mode: str = "text", rows: int = 4, bucket: int = 64,
                 seg_frames: int = 16, cache_len: int = 512,
                 max_frames: int = 128, temperature: float = 0.9,
                 topk: int = 1, seed: int = 888,
                 use_cfg: bool = False, cfg_scale: float = 1.0,
                 cache_dtype=torch.bfloat16,
                 attn_block: Optional[int] = None,
                 seg_ladder: Optional[str] = None,
                 seg_reactive: Optional[str] = None,
                 windows: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_write: Optional[str] = None):
        if mode not in ("text", "audio"):
            raise ValueError(f"mode={mode!r}: expected text or audio")
        if use_cfg and mode != "audio":
            raise ValueError("CFG guides audio generation (TTS/TTA)")
        if use_cfg and rows % 2:
            raise ValueError("CFG rows come in [cond, uncond] pairs")
        self.params = params
        self.cfg = cfg
        self.mode = mode
        self.device = params["audio_embeddings"].device
        # deferred KV writes need the STACKED cache layout
        self.kv_write = resolve_kv_write(kv_write)
        self._cache_lists = isinstance(
            params.get("backbone", {}).get("layers"), list
        ) and self.kv_write != "deferred"
        self.rows = rows
        self.use_cfg = use_cfg
        self._pair = 2 if use_cfg else 1
        self.bucket = bucket
        self.seg_frames = seg_frames
        self.cache_len = cache_len
        self.max_frames = max_frames
        self.seed = seed
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._results: Dict[int, Any] = {}
        # wall-clock lifecycle per request: submitted / admitted / first /
        # done / frames; "first" is stamped when the request's first frame
        # reaches the host (a program's end: the TTFT of this design)
        self.timings: Dict[int, Dict[str, float]] = {}
        self._next_rid = 0
        if attn_block is None:
            env = os.environ.get("UA2_ATTN_BLOCK", "auto")
            attn_block = -1 if env == "auto" else int(env)
        self.attn_block = resolve_attn_block(int(attn_block), cache_len)
        self._cache_dtype = resolve_kv_quant(kv_quant, cache_len, cache_dtype,
                                             batch=rows)
        self.seg_ladder = self._resolve_ladder(seg_ladder, seg_frames)
        self.reactive = self._resolve_reactive(seg_reactive)
        self.drain_cap = cache_len - bucket
        self._slab_frames = max(self.seg_ladder[-1], self.drain_cap)
        self.levels = gpt._prefix_levels(cache_len, self.attn_block)
        self._deferred = self.kv_write == "deferred"
        if windows is None:
            windows = int(os.environ.get("UA2_WINDOWS", "2"))
        if windows not in (1, 2):
            raise ValueError(f"windows={windows}: only 1 or 2")
        self.max_windows = windows
        self._temperature = temperature
        self._topk = topk
        self._cfg_scale = cfg_scale
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._generation = 0
        ts = cfg.tokens
        self._slot_idx = torch.arange(cache_len, device=self.device)
        fb = torch.zeros((rows, 1, ts.parallel_number), dtype=torch.bool,
                         device=self.device)
        fb[..., :-1] = True
        self._audio_fb, self._text_fb = fb, ~fb
        self.capture_seconds = 0.0
        self.frames_run = 0         # frames the device ran (replays, warm-ups)
        self.refills_run = 0        # rows refilled on the device
        self._win = self._new_window()
        self._spare: Optional[_Window] = None
        self._overlap: Optional[_Window] = None
        self._flip = False
        self.stats = {"segments": 0, "drains": 0, "refills": 0, "resets": 0,
                      "reactive": 0, "overlaps": 0}

    # -- windows ------------------------------------------------------------

    def _new_window(self) -> _Window:
        b, dev = self.rows, self.device
        par = self.cfg.tokens.parallel_number

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = SlotState(
            pos=zeros(1), active=zeros(b, dtype=torch.bool),
            frame_tokens=zeros(b, 1, par),
            frame_mask=zeros(b, 1, par, dtype=torch.bool),
            is_reason=zeros(b, dtype=torch.bool), forbid_prefix=zeros(b),
            valid_from=zeros(b), stop_at=zeros(b), keys=zeros(b),
            frame=zeros(1),
            caches=unified.init_caches(
                self.cfg, b, dtype=self._cache_dtype, seq_len=self.cache_len,
                as_lists=self._cache_lists, device=dev))
        local = unified.init_local_cache(
            self.cfg, b, self.params["audio_embeddings"].dtype, dev)
        win = _Window(state, self._slab_frames, b // self._pair, local, dev)
        self._fresh(win)
        return win

    def _fresh(self, win: _Window) -> None:
        """Reset ``win`` to a fresh window, in place (its graphs keep
        reading the same buffers): position at the bucket, every row free
        and fully masked, zero caches, the next generation's stream."""
        s = win.state
        s.pos.fill_(self.bucket)
        s.active.zero_()
        s.frame_tokens.zero_()
        s.frame_mask.zero_()
        s.is_reason.fill_(True)
        s.forbid_prefix.zero_()
        s.valid_from.fill_(self.cache_len)
        s.stop_at.zero_()
        s.frame.zero_()
        s.keys.copy_(RowKeys.from_seeds(range(self.rows), self.device)
                     .fold(self.seed).fold(self._generation).keys)
        self._generation += 1
        for t in _cache_tensors(s.caches):
            t.zero_()
        win.pos = self.bucket
        win.slots = [_Slot() for _ in range(self.rows // self._pair)]

    # -- per-window host-state proxies (the primary window) -----------------

    @property
    def _state(self) -> SlotState:
        return self._win.state

    @property
    def _pos_host(self) -> int:
        return self._win.pos

    @property
    def _slots(self) -> List[_Slot]:
        return self._win.slots

    @staticmethod
    def _resolve_ladder(spec: Optional[str], seg_frames: int) -> tuple:
        """Parse the segment-length ladder: "off"/"0" -> fixed segments,
        "auto"/None -> (2, seg_frames) (the short rung only on segments
        that carry an admission), or an explicit "2,4,8" (three or more
        rungs add the middle rung while a row is free). Entries are
        deduped, capped at ``seg_frames`` and sorted. Env default:
        ``UA2_SEG_LADDER``."""
        if spec is None:
            spec = os.environ.get("UA2_SEG_LADDER", "auto")
        spec = str(spec).strip().lower()
        if spec in ("off", "0", ""):
            return (seg_frames,)
        if spec == "auto":
            ks = (2, seg_frames)
        else:
            try:
                ks = tuple(int(x) for x in spec.split(","))
            except ValueError:
                raise ValueError(
                    f"UA2_SEG_LADDER={spec!r}: expected 'auto', 'off', or "
                    "a comma-separated length list like '2,4,8'")
        ks = sorted({max(1, min(int(k), seg_frames)) for k in ks})
        return tuple(ks) or (seg_frames,)

    @staticmethod
    def _resolve_reactive(spec: Optional[str]) -> bool:
        """Row-free-reactive gate: "on"/"1" runs the early-exit segment,
        "off"/"0"/"auto"/None does not (the JAX package's measured
        default). Env default: ``UA2_SEG_REACTIVE``."""
        if spec is None:
            spec = os.environ.get("UA2_SEG_REACTIVE", "auto")
        spec = str(spec).strip().lower()
        if spec in ("on", "1"):
            return True
        if spec in ("off", "0", "auto", ""):
            return False
        raise ValueError(
            f"UA2_SEG_REACTIVE={spec!r}: expected on/off/auto")

    # -- the frame step -----------------------------------------------------

    def _frame(self, win: _Window, host_pos: int) -> None:
        """One decode frame over the window's rows, in place, writing the
        packed (B, ncb + 3) row [text, audio x ncb, phase, done] at slab
        column ``k``. ``host_pos`` (at or past the device position) only
        picks the prefix level. Reads nothing back from the device."""
        ts = self.cfg.tokens
        ncb = ts.num_codebooks
        s = win.state
        live = win.enable & (win.always | s.active.any())        # (1,)
        key_valid = self._slot_idx[None, :] >= s.valid_from[:, None]
        frame, _ = unified.decode_frame(
            self.params, self.cfg, s.frame_tokens, s.frame_mask, s.caches,
            s.pos, RowKeys(s.keys).fold(s.frame),
            temperature=self._temperature, topk=self._topk,
            forbid_prefix=s.forbid_prefix[:, None], use_cfg=self.use_cfg,
            cfg_scale=self._cfg_scale, sample_text=self.mode == "text",
            sample_audio=self.mode == "audio", key_valid=key_valid,
            attn_block=self.attn_block, kv_write=self.kv_write,
            host_pos=host_pos, local=win.local)
        text_tok, audio_toks = frame[:, 0], frame[:, 1:]
        act = s.active
        cap_hit = s.pos + 1 >= s.stop_at                      # (B,)
        if self.mode == "text":
            eos_now = text_tok == ts.text_eos
            done_now = act & (eos_now | cap_hit)
            emit = torch.where(act & ~eos_now, text_tok, -1)
            audio_col = torch.zeros_like(audio_toks)
            phase = torch.full_like(text_tok, PHASE_DROPPED)
            tokens = torch.zeros_like(s.frame_tokens)
            tokens[:, 0, -1] = text_tok
            tmask = self._text_fb
            is_reason, forbid = s.is_reason, s.forbid_prefix
        else:
            sem_eos = torch.all(
                audio_toks == ts.semantic_eos + ts.audio_reason_card, dim=1)
            switch = s.is_reason & torch.all(audio_toks == ts.reason_eos,
                                             dim=1)
            done_now = act & (sem_eos | cap_hit)
            save_now = act & ~switch & ~sem_eos
            is_reason = s.is_reason & ~switch
            phase = torch.where(
                save_now,
                torch.where(is_reason, PHASE_REASON, PHASE_SEMANTIC),
                PHASE_DROPPED)
            forbid = torch.where(switch, ts.audio_reason_card,
                                 s.forbid_prefix)
            emit = torch.where(act, text_tok, -1)
            audio_col = audio_toks
            tokens = frame.roll(-1, dims=1)[:, None, :]
            tmask = self._audio_fb
        packed = torch.cat([emit[:, None], audio_col, phase[:, None],
                            done_now[:, None].long()], dim=1)
        old = win.slab.index_select(1, win.k)
        win.slab.index_copy_(1, win.k,
                             torch.where(live, packed[:, None], old))
        active = torch.where(live, act & ~done_now, act)
        s.is_reason.copy_(torch.where(live, is_reason, s.is_reason))
        s.forbid_prefix.copy_(torch.where(live, forbid, s.forbid_prefix))
        s.frame_tokens.copy_(torch.where(live, tokens, s.frame_tokens))
        s.frame_mask.copy_(torch.where(live, tmask, s.frame_mask))
        win.freed.copy_((done_now.any() | ~active.any()) & live)
        s.active.copy_(active)
        s.pos.add_(live)
        s.frame.add_(live)
        win.k.add_(live)

    def level(self, host_pos: int):
        """The prefix level a frame at ``host_pos`` reads (None: one read
        of the whole cache)."""
        if self.levels is None:
            return None
        return pick_level(self.levels, host_pos + 1 - self._deferred)

    def _capture(self, win: _Window, host_pos: int) -> None:
        """Warm up and capture the step of ``host_pos``'s level on the
        window's buffers. The warm-up frame runs with ``enable`` off, so it
        changes no state but the cache slot at the device position, which
        the next frame writes before anything reads it."""
        t0 = time.perf_counter()
        win.enable.fill_(False)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            self._frame(win, host_pos)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            win.graphs[self.level(host_pos)] = _cuda.capture_graph(
                lambda: self._frame(win, host_pos), pool=self._pool)
        win.enable.fill_(True)
        self.frames_run += 1
        self.capture_seconds += time.perf_counter() - t0

    def _step(self, win: _Window, host_pos: int) -> None:
        """One frame: a replay of the level's graph on a card (captured on
        first use), the step itself on the CPU."""
        self.frames_run += 1
        if self.device.type != "cuda":
            with torch.no_grad():
                self._frame(win, host_pos)
            return
        lvl = self.level(host_pos)
        if lvl not in win.graphs:
            self._capture(win, host_pos)
        graph, counts = win.graphs[lvl]
        graph.replay()
        _cuda.add_counts(counts, 1)

    def _start(self, win: _Window, always: bool) -> None:
        win.k.zero_()
        win.always.fill_(always)

    def _slab(self, win: _Window, steps: int) -> np.ndarray:
        """The program's (B, steps, ncb + 3) outputs, one copy to the host
        (a copy on the CPU too: the next program overwrites the slab)."""
        return win.slab[:, :steps].cpu().numpy().copy()

    # -- the programs -------------------------------------------------------

    def _refill(self, win: _Window, refills) -> None:
        """The refills of a segment's prologue, eagerly, in place: a CFG
        request takes two rows (cond 2p, uncond 2p+1)."""
        if not refills:
            return
        par = self.cfg.tokens.parallel_number
        with torch.no_grad():
            for r, req in refills:
                prompts = [(req.grid, req.mask)]
                if self.use_cfg:
                    prompts.append((req.neg_grid, req.neg_mask))
                for j, (g, m) in enumerate(prompts):
                    length = g.shape[0]
                    grid = np.zeros((self.bucket, par), np.int64)
                    mask = np.zeros((self.bucket, par), bool)
                    grid[self.bucket - length:] = g
                    mask[self.bucket - length:] = m
                    self.refills_run += 1
                    _refill_one(
                        self.params, self.cfg, win.state, r * self._pair + j,
                        torch.from_numpy(grid).to(self.device),
                        torch.from_numpy(mask).to(self.device), length,
                        req.max_frames, self.bucket, win.pos, self.attn_block)

    def _segment(self, win: _Window, refills, k: int) -> np.ndarray:
        """Refill prologue + K frames (the position advances on each)."""
        self._refill(win, refills)
        self._start(win, True)
        for i in range(k):
            self._step(win, win.pos + i)
        win.pos += k
        return self._slab(win, k)

    def _reactive_burst(self, win: _Window, cap: int) -> np.ndarray:
        """Up to ``cap`` frames, stopping after the frame in which a row
        completes (or when no row is live), read after every frame."""
        self._start(win, False)
        cap = min(cap, self.cache_len - 1 - win.pos)
        steps = 0
        if cap > 0 and bool(win.state.active.any()):
            while steps < cap:
                self._step(win, win.pos + steps)
                steps += 1
                if bool(win.freed):
                    break
        win.pos += steps
        return self._slab(win, steps)

    def _drain_frames(self, win: _Window) -> np.ndarray:
        """Decode until every row is inactive, ``drain_cap`` frames or the
        cache end: the stop flag is read every `STOP_EVERY` frames, the
        frames that ran (replays past the last completion change nothing)
        from the device counter at the end."""
        self._start(win, False)
        cap = min(self.drain_cap, self.cache_len - 1 - win.pos)
        n = 0
        while n < cap:
            for _ in range(min(STOP_EVERY, cap - n)):
                self._step(win, win.pos + n)
                n += 1
            if not bool(win.state.active.any()):
                break
        steps = int(win.k.cpu().numpy()[0])
        win.pos += steps
        return self._slab(win, steps)

    # -- client API ---------------------------------------------------------

    def submit(self, grid: np.ndarray, mask: np.ndarray,
               max_frames: Optional[int] = None,
               neg_grid: Optional[np.ndarray] = None,
               neg_mask: Optional[np.ndarray] = None) -> int:
        """Enqueue one request (grid from `engine/tasks.py`). Returns its id.
        Under ``use_cfg`` a negative (pad-substituted, same-length) prompt
        is required (`tasks.prepare_tts_cfg_negative`)."""
        if grid.shape[0] > self.bucket:
            raise ValueError(
                f"prompt ({grid.shape[0]}) exceeds bucket ({self.bucket})")
        if self.use_cfg:
            if neg_grid is None or neg_mask is None:
                raise ValueError(
                    "use_cfg engines need a negative prompt per request")
            if neg_grid.shape != grid.shape:
                raise ValueError(
                    "CFG negative prompt must match the prompt length "
                    "(pad-substitution, tts_task.py:171-189)")
        elif neg_grid is not None or neg_mask is not None:
            raise ValueError("a negative prompt needs a use_cfg engine")
        mf = max_frames or self.max_frames
        if mf > self.cache_len - 1 - self.bucket:
            raise ValueError(
                f"max_frames ({mf}) can never fit the cache budget "
                f"({self.cache_len - 1 - self.bucket} frames after the "
                f"bucket)")
        rid = self._next_rid
        self._next_rid += 1
        self.timings[rid] = {"submitted": time.monotonic()}
        self._queue.put(_Request(
            rid, np.asarray(grid), np.asarray(mask), mf,
            None if neg_grid is None else np.asarray(neg_grid),
            None if neg_mask is None else np.asarray(neg_mask)))
        return rid

    def run_offline(self, requests, max_frames: Optional[int] = None
                    ) -> List[Any]:
        """Continuous batching over a known request list (offline batch
        eval): ``requests`` is a list of (grid, mask) or (grid, mask,
        max_frames); under ``use_cfg`` (grid, mask, neg_grid, neg_mask[,
        max_frames]). A request is admitted into a row the frame after the
        row frees (refill on completion; the host reads "a row completed"
        after every frame while requests wait, then drains), longest budget
        first; the shared position resets to the bucket when every row is
        free and the next budget no longer fits. Returns the results in
        input order (the formats of `run_until_drained`)."""
        prepared = []
        for item in requests:
            g, m = np.asarray(item[0]), np.asarray(item[1])
            if self.use_cfg:
                neg = (np.asarray(item[2]), np.asarray(item[3]))
                if neg[0].shape != g.shape:
                    raise ValueError("CFG negative prompt must match the "
                                     "prompt length")
                mf = item[4] if len(item) > 4 else (
                    max_frames or self.max_frames)
            else:
                neg = (None, None)
                mf = item[2] if len(item) > 2 else (
                    max_frames or self.max_frames)
            if g.shape[0] > self.bucket or \
                    mf > self.cache_len - 1 - self.bucket:
                raise ValueError(
                    f"request (prompt {g.shape[0]}, {mf} frames) does not "
                    f"fit bucket {self.bucket} / cache {self.cache_len}")
            prepared.append(_Request(len(prepared), g, m, int(mf), *neg))
        win = self._win
        if self._overlap is not None or not self._queue.empty() or any(
                s.request_id >= 0 for s in win.slots):
            raise RuntimeError("run_offline needs an engine with no online "
                               "work in flight")
        # longest-processing-time-first admission: rows stay balanced and
        # the makespan tail shrinks
        pending = deque(sorted(prepared, key=lambda r: -r.max_frames))
        self._fresh(win)
        saved = self._results, self.timings
        self._results, self.timings = {}, {}
        try:
            while pending or any(s.request_id >= 0 for s in win.slots):
                busy = any(s.request_id >= 0 for s in win.slots)
                if not busy and self._remaining(win) < pending[0].max_frames:
                    win.pos = self.bucket            # the position only
                    win.state.pos.fill_(self.bucket)
                refills = []
                for u, slot in enumerate(win.slots):
                    if slot.request_id >= 0 or not pending or \
                            self._remaining(win) < pending[0].max_frames:
                        continue
                    req = pending.popleft()
                    win.slots[u] = _Slot(request_id=req.rid,
                                         max_frames=req.max_frames)
                    refills.append((u, req))
                self._refill(win, refills)
                slab = (self._reactive_burst(win, self.drain_cap) if pending
                        else self._drain_frames(win))
                self._harvest(win, slab)
            out = [self._results[r.rid] for r in prepared]
        finally:
            self._results, self.timings = saved
            self._fresh(win)
        return out

    def stream(self, grid: np.ndarray, mask: np.ndarray,
               max_frames: Optional[int] = None):
        """Generator over one request's frames as they are produced (audio
        mode, single-row engine): yields (phase, audio_frame (8,)) per
        frame, segment by segment: the LLM half of streaming TTS
        (`engine/stream_tts.py`). Phases follow `decode.PHASE_*`; semantic
        codes still carry the +audio_reason_card offset."""
        if self.mode != "audio" or self.rows != 1 or self.use_cfg:
            raise ValueError("stream() needs a rows=1 audio engine without "
                             "CFG")
        if not self._queue.empty() or self._slots[0].request_id >= 0:
            raise RuntimeError("stream() needs an idle engine")
        mf = max_frames or self.max_frames
        self.submit(grid, mask, mf)
        ncb = self.cfg.tokens.num_codebooks
        emitted = 0
        done = False
        win = self._win
        try:
            while not done:
                refills = self._gather_refills(win)
                if not refills and win.slots[0].request_id < 0:
                    if not self._queue.empty():
                        # not admissible at this position (the cache budget
                        # spent by earlier streams): reset and retry
                        self._reset(win)
                        continue
                    break
                slab = self._segment(win, refills, self.seg_frames)
                self.stats["segments"] += 1
                for kf in range(slab.shape[1]):
                    if emitted >= mf:
                        done = True
                        break
                    yield int(slab[0, kf, 1 + ncb]), slab[0, kf, 1:1 + ncb]
                    emitted += 1
                    if slab[0, kf, 2 + ncb]:
                        done = True
                        break
        finally:
            win.slots[0] = _Slot()

    def step_online(self) -> Dict[int, Any]:
        """One ONLINE scheduling iteration: admit what is admissible from
        the queue, run one segment if there is work, and return the
        requests it completed ({rid: result}). Returns {} without touching
        the device when idle. The wall-clock lifecycle of each request is
        in `timings`."""
        if self._overlap is not None:
            self._step_overlap()
            done, self._results = self._results, {}
            return done
        win = self._win
        refills = self._gather_refills(win)
        busy = any(s.request_id >= 0 for s in win.slots)
        if not refills and not busy:
            if self._queue.empty():
                if self._remaining(win) < self.max_frames:
                    # refresh a nearly spent window while idle, so the next
                    # arrival admits at once
                    self._reset(win)
                return {}
            # queued work that does not fit at this position: reset, retry
            self._reset(win)
            return {}
        if not refills and not self._queue.empty():
            head: _Request = self._queue.queue[0]
            if self._remaining(win) < head.max_frames:
                if self.max_windows > 1:
                    # budget-blocked with rows running: open a fresh overlap
                    # window and admit the arrival there now
                    self._overlap = self._take_spare()
                    self._flip = False
                    self.stats["overlaps"] += 1
                    self._step_overlap()
                else:
                    # one window: finish the running rows in one drain; the
                    # next call resets and admits
                    self._run_drain(win)
            elif self.reactive:
                # row-blocked: decode reactively so that the row-free
                # event surfaces at the frame it happens
                if not self._run_reactive(win):
                    self._run_segment(win, refills, self.seg_ladder[-1])
            else:
                self._run_segment(win, refills, self._pick_seg(win, refills))
        else:
            self._run_segment(win, refills, self._pick_seg(win, refills))
        done, self._results = self._results, {}
        return done

    def _take_spare(self) -> _Window:
        """The second window, fresh: made once, then reused."""
        if self._spare is None:
            self._spare = self._new_window()
        else:
            self._fresh(self._spare)
        win, self._spare = self._spare, None
        return win

    def _step_overlap(self) -> None:
        """One iteration while two windows are live: the fresh (admitting)
        window and the old (draining) one alternate segments; the old one
        retires the moment its last row completes. The turn flag starts
        on the fresh window's side whenever an overlap opens or is
        promoted (JAX's ``_flip`` kept its last value across overlaps)."""
        ow = self._overlap
        if not any(s.request_id >= 0 for s in self._win.slots):
            # the old window drained: the overlap becomes primary
            self._spare, self._win = self._win, ow
            self._overlap = None
            self._flip = False
            refills = self._gather_refills(ow)
            if refills or any(s.request_id >= 0 for s in ow.slots):
                self._run_segment(ow, refills, self._pick_seg(ow, refills))
            return
        if not self._flip:
            refills = self._gather_refills(ow)
            if refills or any(s.request_id >= 0 for s in ow.slots):
                self._run_segment(ow, refills, self._pick_seg(ow, refills))
                self._flip = True
                return
        self._run_segment(self._win, [], self.seg_ladder[-1])
        self._flip = False

    def run_until_drained(self) -> Dict[int, Any]:
        """Process the queue and the work in flight to completion; returns
        {rid: result}: mode text -> 1-D token array; mode audio ->
        (reason (8, T1), semantic (8, T2))."""
        while self._overlap is not None:
            self._step_overlap()
        win = self._win
        while not self._queue.empty() or any(
                s.request_id >= 0 for s in win.slots):
            refills = self._gather_refills(win)
            busy = any(s.request_id >= 0 for s in win.slots)
            if not refills and not busy:
                if self._queue.empty():
                    break
                self._reset(win)
                continue
            if self._queue.empty() and not refills:
                self._run_drain(win)
            else:
                self._run_segment(win, refills, self._pick_seg(win, refills))
        out, self._results = self._results, {}
        return out

    # -- scheduling ---------------------------------------------------------

    def _remaining(self, win: Optional[_Window] = None) -> int:
        win = self._win if win is None else win
        return self.cache_len - 1 - win.pos

    def _reset(self, win: _Window) -> None:
        self._fresh(win)
        self.stats["resets"] += 1

    def _gather_refills(self, win: Optional[_Window] = None):
        """Pop admissible queued requests into free slots (host bookkeeping;
        the device writes happen at the next segment's start)."""
        win = self._win if win is None else win
        refills = []
        for r, slot in enumerate(win.slots):
            if slot.request_id >= 0 or self._queue.empty():
                continue
            req: _Request = self._queue.queue[0]
            if self._remaining(win) < req.max_frames:
                continue
            self._queue.get()
            win.slots[r] = _Slot(request_id=req.rid,
                                 max_frames=req.max_frames)
            refills.append((r, req))
            self.stats["refills"] += 1
            t = self.timings.get(req.rid)
            if t is not None:
                t["admitted"] = time.monotonic()
        return refills

    def _pick_seg(self, win: _Window, refills) -> int:
        """This boundary's segment length: the shortest rung on a segment
        that carries an admission, the longest when nothing admits; a
        ladder of three or more rungs takes the middle one while a row is
        free."""
        if len(self.seg_ladder) == 1:
            return self.seg_ladder[-1]
        if refills:
            return self.seg_ladder[0]
        if len(self.seg_ladder) > 2 and any(
                s.request_id < 0 for s in win.slots):
            return self.seg_ladder[1]
        return self.seg_ladder[-1]

    def _run_segment(self, win: _Window, refills,
                     k: Optional[int] = None) -> None:
        slab = self._segment(win, refills, self.seg_frames if k is None else k)
        self.stats["segments"] += 1
        self._harvest(win, slab)

    def _run_reactive(self, win: _Window) -> bool:
        """One reactive burst; False when it made no progress (the caller
        then runs a plain segment)."""
        slab = self._reactive_burst(win, self.seg_frames)
        self.stats["reactive"] += 1
        if slab.shape[1]:
            self._harvest(win, slab)
        return slab.shape[1] > 0

    def _run_drain(self, win: Optional[_Window] = None) -> None:
        win = self._win if win is None else win
        slab = self._drain_frames(win)
        self.stats["drains"] += 1
        self._harvest(win, slab)

    def warmup(self) -> None:
        """Capture every prefix level's graph of the window(s) and run each
        program once (a refill, every ladder segment, the reactive segment,
        the drain) with no live request, then reset the windows: no capture
        or first-call set-up lands on a request's latency."""
        wins = [self._win]
        if self.max_windows > 1:
            if self._spare is None and self._overlap is None:
                self._spare = self._new_window()
            wins += [w for w in (self._spare, self._overlap) if w is not None]
        for win in wins:
            if self.device.type == "cuda":
                seen = set()
                for p in range(self.bucket, self.cache_len - 1):
                    if self.level(p) not in seen:
                        seen.add(self.level(p))
                        if self.level(p) not in win.graphs:
                            self._capture(win, p)
        par = self.cfg.tokens.parallel_number
        win = self._win
        one = _Request(-1, np.zeros((1, par), np.int64),
                       np.ones((1, par), bool), 1)
        self._refill(win, [(0, one)])
        win.state.active.zero_()
        for k in self.seg_ladder:
            self._segment(win, [], k)
        if self.reactive:
            self._reactive_burst(win, self.seg_frames)
        self._drain_frames(win)
        for w in wins:
            self._fresh(w)

    def _harvest(self, win: _Window, slab: np.ndarray) -> None:
        ncb = self.cfg.tokens.num_codebooks
        now = time.monotonic()
        for u, slot in enumerate(win.slots):
            if slot.request_id < 0:
                continue
            r = u * self._pair      # CFG reads the cond row of the pair
            had_frames = len(slot.text)
            for kf in range(slab.shape[1]):
                slot.text.append(int(slab[r, kf, 0]))
                slot.audio.append(slab[r, kf, 1:1 + ncb])
                slot.phase.append(int(slab[r, kf, 1 + ncb]))
                if slab[r, kf, 2 + ncb]:
                    self._stamp(slot, had_frames, now)
                    self._finalize(win, u)
                    break
            else:
                self._stamp(slot, had_frames, now)
                if len(slot.text) >= slot.max_frames:
                    self._finalize(win, u)

    def _stamp(self, slot: _Slot, had_frames: int, now: float) -> None:
        t = self.timings.get(slot.request_id)
        if t is not None and had_frames == 0 and slot.text:
            t.setdefault("first", now)

    def _finalize(self, win: _Window, r: int) -> None:
        slot = win.slots[r]
        mf = slot.max_frames or self.max_frames
        t = self.timings.get(slot.request_id)
        if t is not None:
            t["done"] = time.monotonic()
            t["frames"] = min(len(slot.phase), mf)
        slot.text = slot.text[:mf]
        slot.audio = slot.audio[:mf]
        slot.phase = slot.phase[:mf]
        if self.mode == "text":
            toks = np.asarray([t for t in slot.text if t >= 0], np.int64)
            self._results[slot.request_id] = toks
        else:
            audio = np.stack(slot.audio) if slot.audio else \
                np.zeros((0, self.cfg.tokens.num_codebooks), np.int64)
            phase = np.asarray(slot.phase, np.int64)
            self._results[slot.request_id] = split_two_phase(
                audio, phase, len(slot.phase),
                self.cfg.tokens.audio_reason_card)
        win.slots[r] = _Slot()
