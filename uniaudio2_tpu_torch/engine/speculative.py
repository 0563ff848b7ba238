"""Speculative decoding for the unified audio LM (port of
`uniaudio2_tpu/engine/speculative.py`).

A cheap DRAFT model proposes k frames greedily, the TARGET model verifies
all of them in ONE multi-position forward, and the longest agreeing prefix
is accepted. The natural configuration is an int4all draft checked by an
int8 target built from the same weights (self-drafting by quantization).

One round, as JAX's ``_build_spec_generate`` body:

1. k greedy draft frames f_0..f_{k-1} (`unified.decode_frame`, top-1),
   each with the ``forbid_prefix`` it was drawn under, then one draft step
   that only INGESTS f_{k-1}'s feedback at ``pos + k`` (the draft cache
   stays gap-free for any accept length);
2. the target's verify: one T = k + 1 step over [f_-1, f_0..f_{k-1}] at
   ``pos`` -> hidden states h_0..h_k (`unified.decode_hidden_all`); the
   lm_head at M = k (text) or the local decoder TEACHER-FORCED on the
   drafted codebooks (`_local_decoder_score`, audio);
3. ``n_acc``, the first mismatch (k when every frame matches);
4. one fresh frame from the target at h[n_acc]: the correction, or the
   bonus frame;
5. the emit of up to k + 1 frames through the plain loop's per-frame state
   machine (text EOS, the two-phase switch and ``forbid_prefix``, phase
   tags, the ``max_frames`` and ``cache_len - 1`` caps).

KV "rewind" is free: the caches are static buffers read under a position
mask, every slot <= the new position holds accepted inputs, and the stale
slots beyond it are rewritten by the next round before anything reads
them.

On the card a round is one captured CUDA graph. Its state (step, position,
finished, feedback, ``is_reason``, ``forbid_prefix``, both caches, the
output buffers, the statistics) lives in static device buffers; ``n_acc``,
the slice at ``n_acc`` and the accept and emit loops are device tensor ops
over k / k + 1 fixed steps under masks, so a round reads nothing back. The
host reads (step, pos, finished) once a round, takes the prefix level that
covers the round's reads (``pos + k + 1`` slots) and replays that level's
graph. A level's graph is captured on first use, after one warm-up round
on a side stream whose effect on the state buffers is undone (it leaves
only cache slots at and beyond ``pos``, which the replay rewrites before
it reads them). On the CPU the same round runs eagerly, its warm-up
included. Both prefills run eagerly, as `DecodeEngine`'s do.

Exactness: on the CPU in float32 the emitted stream equals the target's
plain greedy decode for ANY draft, as in JAX. On the card a row's
arithmetic depends on M (the verify runs the target at M = k + 1, the
score at M = k, the plain decode at M = 1, and each M picks its own
split-K plan), so at a near-tie the two streams may part: they agree up to
a tie that the M-plans' difference covers, not bit for bit.

The teacher-forced local decoder runs its QKV step at M = k rows: k above
16 (`quant.SPLITK_MAX_M`) would take row 3's first design, which no path
serves; the default k is 4.

Greedy only, as JAX: sampling arguments are ignored.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.engine.decode import (
    DEFAULT_BUCKETS, KEEP_PROGRAMS, PHASE_DROPPED, PHASE_REASON,
    PHASE_SEMANTIC, pick_bucket, resolve_attn_block, split_two_phase,
)
from uniaudio2_tpu_torch.engine.frame_graph import pool_bytes
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.models.unified import (
    decode_hidden_all as _decode_hidden_all,
)
from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.attention import pick_level
from uniaudio2_tpu_torch.ops.quant import matmul
from uniaudio2_tpu_torch.ops.sampling import _mask_prefix

Params = Dict[str, Any]


def _local_decoder_score(params: Params, cfg: UnifiedModelConfig,
                         last_h: torch.Tensor, frames: torch.Tensor,
                         forbid_prefix: torch.Tensor,
                         local: Optional[unified.LocalCache] = None
                         ) -> torch.Tensor:
    """The target's argmax of every codebook of N frames at once
    (``last_h`` (N, D_backbone), drafted ``frames`` (N, 8)): microstep i is
    fed the DRAFTED codebook i - 1 (teacher forcing), so the k-frame verify
    is one batched 8-microstep pass. The layouts as
    `unified._local_decoder_generate`: the folded ``audio_embeddings_proj``
    table or ``projection_w`` at every step, the heads a list or stacked.
    ``forbid_prefix`` (N,) masks each row's ids below it. ``local`` is a
    kept N-row local cache (else one is made). Returns (N, 8) ids."""
    n = last_h.shape[0]
    ncb = cfg.tokens.num_codebooks
    audio_vocab = cfg.tokens.audio_vocab
    if local is None:
        local = unified.init_local_cache(cfg, n, last_h.dtype, last_h.device)
    cache, steps = local
    proj_table = params.get("audio_embeddings_proj")
    heads = params["audio_head"]
    if proj_table is None:
        table, curr = params["audio_embeddings"], last_h[:, None, :]
    else:
        table = proj_table
        curr = matmul(last_h, params["projection_w"]).to(
            proj_table.dtype)[:, None, :]
    out = []
    for i in range(ncb):
        proj = curr if proj_table is not None \
            else matmul(curr, params["projection_w"])
        dec_h, cache = gpt.decode_step(params["decoder"], cfg.decoder, proj,
                                       cache, steps[i:i + 1])
        head = heads[i] if isinstance(heads, list) \
            else gpt.index_leaf(heads, i)
        logits = matmul(dec_h[:, -1, :], head, out_dtype=torch.float32)
        out.append(torch.argmax(_mask_prefix(logits, forbid_prefix[:, None]),
                                dim=-1))
        if i + 1 < ncb:
            # teacher forcing: feed the DRAFTED codebook i, not the argmax
            curr = table[frames[:, i] + i * audio_vocab][:, None, :]
    return torch.stack(out, dim=1)


def _host(lvl: Optional[int], t: int) -> Optional[int]:
    """The host position a step of ``t`` queries passes so that the prefix
    level it reads is ``lvl`` (`gpt.decode_step` picks the level covering
    ``host_pos + t`` slots; None: no levels)."""
    return None if lvl is None else lvl - t


class _Program:
    """The round of one (mode, bucket) program over both trees: its static
    buffers, the draft's and the target's caches and, on a card, one
    captured graph per prefix level."""

    def __init__(self, eng: "SpeculativeEngine", mode: str, bucket: int):
        cfg, ts, dev, k = eng.cfg, eng.cfg.tokens, eng.device, eng.k
        self.eng, self.mode = eng, mode
        self.cache_len = min(cfg.max_seq_len,
                             -(-(bucket + eng.max_frames + k + 1) // 256) * 256)
        self.attn_block = resolve_attn_block(eng.attn_block, self.cache_len)
        self.levels = gpt._prefix_levels(self.cache_len, self.attn_block)
        out_cap = eng.max_frames + k + 1   # emit slack; step caps at max_frames

        def caches(p):
            lists = isinstance(p.get("backbone", {}).get("layers"), list)
            return unified.init_caches(cfg, 1, dtype=eng.cache_dtype,
                                       seq_len=self.cache_len, as_lists=lists,
                                       device=dev)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        par, ncb = ts.parallel_number, ts.num_codebooks
        self.d_caches, self.t_caches = caches(eng.draft), caches(eng.target)
        self.ctl = zeros(3)                 # step, pos, finished: one read
        self.step, self.pos, self.fin = (self.ctl[0:1], self.ctl[1:2],
                                         self.ctl[2:3])
        self.tokens = zeros(1, 1, par)      # the feedback frame
        self.tmask = zeros(1, 1, par, dtype=torch.bool)
        self.is_reason = zeros(1, dtype=torch.bool)
        self.forbid = zeros(1)
        self.audio_out = zeros(out_cap, ncb)
        self.phase_out = zeros(out_cap)
        self.text_out = zeros(out_cap)
        self.stats = zeros(3)               # rounds, drafted, accepted
        self._per_round = torch.tensor([1, k], device=dev)
        self.audio_fb = zeros(1, 1, par, dtype=torch.bool)
        self.audio_fb[..., :-1] = True
        self.text_fb = ~self.audio_fb
        self.d_local = unified.init_local_cache(
            cfg, 1, eng.draft["audio_embeddings"].dtype, dev)
        t_dtype = eng.target["audio_embeddings"].dtype
        self.t_local = unified.init_local_cache(cfg, 1, t_dtype, dev)
        self.s_local = unified.init_local_cache(cfg, k, t_dtype, dev)
        self._state = (self.ctl, self.tokens, self.tmask, self.is_reason,
                       self.forbid, self.audio_out, self.phase_out,
                       self.text_out, self.stats)
        # level -> (CUDAGraph, counts of a replay); None once warmed on the CPU
        self.graphs: Dict[Optional[int], Any] = {}
        self.capture_seconds: Dict[Optional[int], float] = {}

    def level(self, host_pos: int) -> Optional[int]:
        """The prefix level covering a round at ``host_pos`` (its reads end
        at slot ``host_pos + k``; None: one read of the whole cache)."""
        if self.levels is None:
            return None
        return pick_level(self.levels, host_pos + self.eng.k + 1)

    def _feedback(self, frames: torch.Tensor):
        """(n, 9) frames [text, cb0..cb7] -> the (1, n, 9) feedback tokens
        and mask: the text token alone (text), or the codebooks (audio)."""
        zeros = torch.zeros_like(frames[:, :1])
        if self.mode == "text":
            toks = torch.cat([zeros.expand(-1, frames.shape[1] - 1),
                              frames[:, :1]], dim=1)
            mask = self.text_fb
        else:
            toks = torch.cat([frames[:, 1:], zeros], dim=1)
            mask = self.audio_fb
        return toks[None], mask.expand(-1, frames.shape[0], -1)

    def _put(self, buf: torch.Tensor, step: torch.Tensor, value: torch.Tensor,
             apply: torch.Tensor) -> None:
        """buf[step] = value where ``apply`` (else unchanged)."""
        buf.index_copy_(0, step, torch.where(apply, value,
                                             buf.index_select(0, step)))

    def _round(self, lvl: Optional[int]) -> None:
        """One speculation round on the static buffers, in place. ``lvl``
        (the prefix level) is what every decode step of the round reads:
        each passes the host position at which that level is the one that
        covers its reads."""
        drafted, forbids = self._draft(lvl)
        h_all, match = self._verify(lvl, drafted, forbids)
        n_acc = self._accept(match)
        fresh = self._fresh(h_all, n_acc, forbids)
        self._emit(drafted, n_acc, fresh)

    def _draft(self, lvl: Optional[int]):
        """Step 1: k greedy draft frames from the feedback, then the draft's
        ingest of the k-th at ``pos + k``. Returns the (k, 9) frames and
        the (k + 1,) ``forbid_prefix`` states: entry j is the one frame j
        was drawn under, the state after frames 0..j-1 (JAX's
        ``acc_state`` after an accepted prefix of j), entry k the state
        after all k."""
        eng, mode, k = self.eng, self.mode, self.eng.k
        cfg, ts = eng.cfg, eng.cfg.tokens
        toks, tmask = self.tokens, self.tmask
        is_r, forbid = self.is_reason, self.forbid
        drafted, forbids = [], []
        for j in range(k):
            frame, _ = unified.decode_frame(
                eng.draft, cfg, toks, tmask, self.d_caches, self.pos + j,
                None, temperature=1.0, topk=1, forbid_prefix=forbid[:, None],
                sample_text=mode == "text", sample_audio=mode == "audio",
                attn_block=self.attn_block, host_pos=_host(lvl, 1),
                local=self.d_local)
            drafted.append(frame)
            forbids.append(forbid)
            if mode == "audio":
                switch = is_r & torch.all(frame[:, 1:] == ts.reason_eos)
                is_r = is_r & ~switch
                forbid = torch.where(switch, ts.audio_reason_card, forbid)
            toks, tmask = self._feedback(frame)
        unified.decode_hidden(eng.draft, cfg, toks, tmask, self.d_caches,
                              self.pos + k, attn_block=self.attn_block,
                              host_pos=_host(lvl, 1))
        return torch.cat(drafted), torch.cat(forbids + [forbid])

    def _verify(self, lvl: Optional[int], drafted: torch.Tensor,
                forbids: torch.Tensor):
        """Step 2: the target over T = k + 1 positions [f_-1, f_0..f_{k-1}]
        at ``pos`` -> its (k + 1, D) hidden states, and whether its argmax
        equals each drafted frame (k,): the lm_head at M = k (text), the
        teacher-forced local decoder (audio)."""
        eng, k = self.eng, self.eng.k
        fb_toks, fb_mask = self._feedback(drafted)
        h_all, _ = _decode_hidden_all(
            eng.target, eng.cfg, torch.cat([self.tokens, fb_toks], dim=1),
            torch.cat([self.tmask, fb_mask], dim=1), self.t_caches, self.pos,
            attn_block=self.attn_block, host_pos=_host(lvl, k + 1))
        h_all = h_all[0]
        if self.mode == "text":
            t_text = torch.argmax(gpt.lm_head(eng.target["backbone"],
                                              h_all[:k], eng.cfg.backbone),
                                  dim=-1)
            return h_all, t_text == drafted[:, 0]
        t_audio = _local_decoder_score(eng.target, eng.cfg, h_all[:k],
                                       drafted[:, 1:], forbids[:k],
                                       local=self.s_local)
        return h_all, torch.all(t_audio == drafted[:, 1:], dim=1)

    @staticmethod
    def _accept(match: torch.Tensor) -> torch.Tensor:
        """Step 3: the longest accepted prefix, (1,): the first mismatch,
        k when every frame matches."""
        return match.long().cumprod(0).sum().reshape(1)

    def _fresh(self, h_all: torch.Tensor, n_acc: torch.Tensor,
               forbids: torch.Tensor) -> torch.Tensor:
        """Step 4: the target's frame (9,) at h[n_acc], under the forbid of
        the accepted prefix: the correction at the first mismatch, or the
        bonus frame."""
        eng, ts = self.eng, self.eng.cfg.tokens
        h_fresh = h_all.index_select(0, n_acc)
        zero = torch.zeros_like(n_acc)
        if self.mode == "text":
            text = torch.argmax(gpt.lm_head(eng.target["backbone"], h_fresh,
                                            eng.cfg.backbone), dim=-1)
            return torch.cat([text, zero.expand(ts.num_codebooks)])
        audio = unified._local_decoder_generate(
            eng.target, eng.cfg, h_fresh, None, temperature=1.0, topk=1,
            forbid_prefix=forbids.index_select(0, n_acc)[:, None],
            use_cfg=False, cfg_scale=1.0, local=self.t_local)
        return torch.cat([zero, audio[0]])

    def _emit(self, drafted: torch.Tensor, n_acc: torch.Tensor,
              fresh: torch.Tensor) -> None:
        """Step 5: frames 0..n_acc (the accepted drafts, then the fresh
        frame) through the plain loop's per-frame state machine, each
        applied while the request is live, under ``max_frames`` and in the
        cache; the state buffers and the statistics updated in place."""
        eng, ts, k = self.eng, self.eng.cfg.tokens, self.eng.k
        j_idx = torch.arange(k + 1, device=n_acc.device)
        frames = torch.where((j_idx < n_acc)[:, None],
                             torch.cat([drafted, drafted[-1:]]), fresh[None])
        fb_toks, fb_mask = self._feedback(frames)
        step, pos, finished = self.step, self.pos, self.fin.bool()
        is_r, forbid = self.is_reason, self.forbid
        toks, tmask = self.tokens, self.tmask
        max_frames, cap = eng.max_frames, self.cache_len - 1
        for j in range(k + 1):
            f = frames[j]
            apply = ((j <= n_acc) & ~finished & (step < max_frames)
                     & (pos < cap))
            if self.mode == "text":
                fin = f[0] == ts.text_eos
                self._put(self.text_out, step,
                          torch.where(fin, -1, f[0:1]), apply)
                finished = finished | (apply & fin)
            else:
                audio = f[1:]
                sem_eos = torch.all(audio == ts.semantic_eos
                                    + ts.audio_reason_card)
                switch = is_r & torch.all(audio == ts.reason_eos)
                new_r = is_r & ~switch
                phase = torch.where(
                    ~switch & ~sem_eos,
                    torch.where(new_r, PHASE_REASON, PHASE_SEMANTIC),
                    PHASE_DROPPED)
                self._put(self.audio_out, step, audio[None], apply)
                self._put(self.phase_out, step, phase, apply)
                finished = finished | (apply & sem_eos)
                is_r = torch.where(apply, new_r, is_r)
                forbid = torch.where(apply & switch, ts.audio_reason_card,
                                     forbid)
            toks = torch.where(apply, fb_toks[:, j:j + 1], toks)
            tmask = torch.where(apply, fb_mask[:, j:j + 1], tmask)
            step = step + apply
            pos = pos + apply
        self.tokens.copy_(toks)
        self.tmask.copy_(tmask)
        self.is_reason.copy_(is_r)
        self.forbid.copy_(forbid)
        self.ctl.copy_(torch.cat([step, pos, finished.long()]))
        self.stats[:2].add_(self._per_round)
        self.stats[2:].add_(n_acc)

    def _warm(self, lvl: Optional[int]) -> None:
        """The warm-up round of ``lvl``, on a card on a side stream then
        captured; its effect on the state buffers is undone (the cache
        slots it wrote, at and beyond ``pos``, the next round rewrites
        before it reads them)."""
        t0 = time.perf_counter()
        saved = [t.clone() for t in self._state]
        if self.eng.device.type != "cuda":
            self._round(lvl)
            for t, s in zip(self._state, saved):
                t.copy_(s)
            self.graphs[lvl] = None
            return
        dev = self.eng.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._round(lvl)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, s in zip(self._state, saved):
            t.copy_(s)
        self.graphs[lvl] = _cuda.capture_graph(lambda: self._round(lvl),
                                               pool=self.eng.graph_pool)
        self.capture_seconds[lvl] = time.perf_counter() - t0

    def run(self, g: torch.Tensor, m: torch.Tensor, length: int):
        """Prefill both trees with the padded prompt (1, bucket, 9), then
        rounds until JAX's stop test fails: ``step < max_frames``, ``pos <
        cache_len - (k + 1)``, not finished. Returns text_out, audio_out,
        phase_out and stats on the host, the frames emitted, and the
        rounds the device ran (replays and warm-ups)."""
        eng, k = self.eng, self.eng.k
        unified.prefill(eng.draft, eng.cfg, g[:, :-1], m[:, :-1],
                        self.d_caches)
        unified.prefill(eng.target, eng.cfg, g[:, :-1], m[:, :-1],
                        self.t_caches)
        last = length - 1
        self.tokens.copy_(g[:, last:last + 1])
        self.tmask.copy_(m[:, last:last + 1])
        self.ctl.copy_(torch.tensor([0, last, 0]))
        self.is_reason.fill_(True)
        self.forbid.zero_()
        self.audio_out.zero_()
        self.phase_out.zero_()
        self.text_out.fill_(-1)
        self.stats.zero_()
        on_card = eng.device.type == "cuda"
        replays: Dict[Optional[int], int] = {}
        run = 0
        while True:
            step, pos, fin = self.ctl.tolist()      # the round's one read
            if not (step < eng.max_frames and pos < self.cache_len - (k + 1)
                    and not fin):
                break
            lvl = self.level(pos)
            if lvl not in self.graphs:
                self._warm(lvl)
                run += 1
            if on_card:
                self.graphs[lvl][0].replay()
                replays[lvl] = replays.get(lvl, 0) + 1
            else:
                self._round(lvl)
            run += 1
        for lvl, n in replays.items():
            _cuda.add_counts(self.graphs[lvl][1], n)
        out = [t.cpu().numpy() for t in (self.text_out, self.audio_out,
                                         self.phase_out, self.stats)]
        return (*out, int(step), run)


class SpeculativeEngine:
    """Greedy speculative decode engine: `DecodeEngine`'s host API for one
    request (`generate_text`, `generate_audio`), plus the acceptance
    statistics of the last call in ``last_stats``.

    ``draft_params`` and ``target_params`` may use different layouts and
    quantizations (an int4all serving draft, an int8 serving target). The
    programs, one per (mode, bucket) with one graph per prefix level, are
    kept for at most `decode.KEEP_PROGRAMS` (least recently used go), in
    one graph memory pool. ``device`` is where both trees lie (default
    ``cuda``; it raises without a card)."""

    def __init__(self, draft_params: Params, target_params: Params,
                 cfg: UnifiedModelConfig, *, k: int = 4,
                 max_frames: int = 500, cache_dtype=torch.bfloat16,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 attn_block: Optional[int] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: no CUDA device here; "
                               f"pass device='cpu' to run on the CPU")
        for name, p in (("draft", draft_params), ("target", target_params)):
            if p["audio_embeddings"].device.type != self.device.type:
                raise ValueError(f"the {name} tree lies on "
                                 f"{p['audio_embeddings'].device}, not on "
                                 f"{self.device}")
        self.cfg = cfg
        self.k = int(k)
        self.max_frames = max_frames
        self.cache_dtype = cache_dtype
        self.buckets = tuple(b for b in buckets if b <= cfg.max_seq_len) \
            or (cfg.max_seq_len,)
        if attn_block is None:
            env = os.environ.get("UA2_ATTN_BLOCK", "auto")
            attn_block = -1 if env == "auto" else int(env)
        self.attn_block = int(attn_block)
        self.draft, self.target = draft_params, target_params
        self.programs: "OrderedDict[Tuple[str, int], _Program]" = OrderedDict()
        self.graph_pool = (torch.cuda.graph_pool_handle()
                           if self.device.type == "cuda" else None)
        self.last_stats: Optional[Dict[str, Any]] = None
        self.rounds_run = 0     # rounds the device ran in the last call
        # (replays and warm-ups)

    @property
    def capture_seconds(self) -> float:
        """Seconds spent warming up and capturing, all kept programs."""
        return sum(sum(p.capture_seconds.values())
                   for p in self.programs.values())

    def pool_bytes(self) -> Optional[int]:
        """Device bytes of the graphs' memory pool (None on the CPU, or
        where the allocator tags no segment with its pool)."""
        return None if self.graph_pool is None else pool_bytes(self.graph_pool)

    def _program(self, mode: str, bucket: int) -> _Program:
        key = (mode, bucket)
        if key in self.programs:
            self.programs.move_to_end(key)
        else:
            self.programs[key] = _Program(self, mode, bucket)
            while len(self.programs) > KEEP_PROGRAMS:
                self.programs.popitem(last=False)
        return self.programs[key]

    def _run(self, mode: str, grid: np.ndarray, mask: np.ndarray):
        length = grid.shape[0]
        bucket = pick_bucket(length, self.buckets)
        par = self.cfg.tokens.parallel_number
        g = np.zeros((1, bucket, par), np.int64)
        m = np.zeros((1, bucket, par), bool)
        g[0, :length] = grid
        m[0, :length] = mask
        prog = self._program(mode, bucket)
        with torch.no_grad():
            text_out, audio_out, phase_out, stats, n, run = prog.run(
                torch.from_numpy(g).to(self.device),
                torch.from_numpy(m).to(self.device), length)
        self.rounds_run = run
        self.last_stats = {
            "rounds": int(stats[0]), "drafted": int(stats[1]),
            "accepted": int(stats[2]),
            "acceptance_rate": float(stats[2]) / max(int(stats[1]), 1),
        }
        return text_out, audio_out, phase_out, n

    def generate_text(self, grid: np.ndarray, mask: np.ndarray,
                      **_) -> np.ndarray:
        """Greedy text decode: the text ids, EOS excluded."""
        text_out, _, _, n = self._run("text", grid, mask)
        toks = text_out[:n]
        return toks[toks >= 0]

    def generate_audio(self, grid: np.ndarray, mask: np.ndarray, **_
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy two-phase audio decode -> (reason (8, T1), semantic (8,
        T2))."""
        _, audio_out, phase_out, n = self._run("audio", grid, mask)
        return split_two_phase(audio_out, phase_out, n,
                               self.cfg.tokens.audio_reason_card)
