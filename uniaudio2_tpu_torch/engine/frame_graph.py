"""The decode engine's frame loop on the device: one frame step, captured
as a CUDA graph and replayed (the counterpart of the JAX engine's
``lax.while_loop``, `uniaudio2_tpu/engine/decode.py:340` and :526).

A `FrameGraph` owns the static buffers of one (mode, rows, cache, sampling
arguments) program: the feedback tokens and mask, the position, a device
frame counter, the per-row ``finished`` / ``is_reason`` / ``forbid``
state, the output buffers and the local decoder's 8-slot cache. Its step
runs `unified.decode_frame` and the per-row state update of
`DecodeEngine._frames` on those buffers in place, and never reads the
device:

* the outputs are written at the device counter (``index_copy_``), not at
  a host int, and the counter and the position advance only while a row is
  live, so a replay after every row has finished changes no output;
* `RowKeys` fold the device counter (the same bits as the host's frame
  number);
* the prefix level of the attention reads is the one input the host picks:
  one graph per level, switched by the host, which knows every frame's
  position (JAX switches on the device, `uniaudio2_tpu/models/gpt.py:463`).

On a CUDA device each level's step is captured once (after one warm-up
step on a side stream) and replayed frame by frame; the stop flag is read
once every `STOP_EVERY` replays. The graphs share one memory pool, and the
caches they write are the engine's, kept across requests. A capture that
fails raises; nothing falls back to the eager loop. On the CPU the same
step runs eagerly, its warm-up included, so the CPU tests hold this body
to the eager loop and to JAX.

A replay runs no Python wrapper, so the kernels' launch counters would
stop counting: each graph keeps the counts its capture made, and each run
of replays adds them times the replays. The warm-up step launches its
kernels and counts them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.attention import pick_level
from uniaudio2_tpu_torch.ops.sampling import RowKeys

STOP_EVERY = 8          # replays between two reads of the stop flag

PHASE_DROPPED, PHASE_REASON, PHASE_SEMANTIC = 0, 1, 2


class FrameGraph:
    """The frame step of one program over ``caches``, its static buffers
    and, on a card, one captured graph per prefix level."""

    def __init__(self, params, cfg: UnifiedModelConfig, caches, *, mode: str,
                 rows: int, max_frames: int, attn_block: int, kv_write: str,
                 temperature: float, topk: int, use_cfg: bool,
                 cfg_scale: float, generator: Optional[torch.Generator],
                 batched: bool, pool=None):
        ts = cfg.tokens
        dev = params["audio_embeddings"].device
        self.params, self.cfg, self.caches = params, cfg, caches
        self.mode, self.device, self.pool = mode, dev, pool
        self.sample = dict(temperature=temperature, topk=topk,
                           use_cfg=use_cfg, cfg_scale=cfg_scale,
                           sample_text=mode == "text",
                           sample_audio=mode == "audio",
                           attn_block=attn_block, kv_write=kv_write)
        self.generator = generator
        cache_len = caches.backbone.max_seq
        self.levels = gpt._prefix_levels(cache_len, attn_block)
        self.deferred = kv_write == "deferred"

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        par, ncb = ts.parallel_number, ts.num_codebooks
        self.tokens = zeros(rows, 1, par)
        self.tmask = zeros(rows, 1, par, dtype=torch.bool)
        self.pos = zeros(1)
        self.step = zeros(1)                    # frames with a live row
        self.finished = zeros(rows, dtype=torch.bool)
        self.is_reason = zeros(rows, dtype=torch.bool)
        self.forbid = zeros(rows)
        self.text_out = zeros(rows, max_frames)
        self.audio_out = zeros(rows, max_frames, ncb)
        self.phase_out = zeros(rows, max_frames)
        self.audio_fb = zeros(rows, 1, par, dtype=torch.bool)
        self.audio_fb[..., :-1] = True
        self.text_fb = ~self.audio_fb
        self.keys = None if generator is not None else zeros(rows)
        self.key_valid = (torch.ones((rows, cache_len), dtype=torch.bool,
                                     device=dev) if batched else None)
        self.local = unified.init_local_cache(
            cfg, rows, params["audio_embeddings"].dtype, dev)
        self.graphs = {}    # level -> (CUDAGraph, counts of a replay); CPU: None
        self.capture_seconds = 0.0
        self.warmups = 0            # warm-up frames of the last `prepare`

    def level(self, host_pos: int) -> Optional[int]:
        """The prefix level a frame at ``host_pos`` reads (None: one read
        of the whole cache), as `gpt.decode_step` picks it."""
        if self.levels is None:
            return None
        return pick_level(self.levels, host_pos + 1 - self.deferred)

    def _stream(self):
        if self.keys is None:
            return self.generator
        return RowKeys(self.keys).fold(self.step)

    def _put(self, buf: torch.Tensor, value: torch.Tensor,
             live: torch.Tensor) -> None:
        """buf[:, step] = value while a row is live (else unchanged)."""
        old = buf.index_select(1, self.step)
        buf.index_copy_(1, self.step,
                        torch.where(live, value.unsqueeze(1), old))

    def _frame(self, host_pos: int) -> None:
        """One frame on the static buffers, in place. ``host_pos`` only
        picks the prefix level."""
        ts = self.cfg.tokens
        live = ~self.finished.all()
        frame, _ = unified.decode_frame(
            self.params, self.cfg, self.tokens, self.tmask, self.caches,
            self.pos, self._stream(), forbid_prefix=self.forbid[:, None],
            key_valid=self.key_valid, host_pos=host_pos, local=self.local,
            **self.sample)
        text_tok, audio_toks = frame[:, 0], frame[:, 1:]
        if self.mode == "text":
            eos_now = text_tok == ts.text_eos
            self._put(self.text_out,
                      torch.where(self.finished | eos_now, -1, text_tok), live)
            self.finished.logical_or_(eos_now)
        else:
            sem_eos = ts.semantic_eos + ts.audio_reason_card
            stop = torch.all(audio_toks == sem_eos, dim=1)
            switch = self.is_reason & torch.all(audio_toks == ts.reason_eos,
                                                dim=1)
            # as `DecodeEngine._frames`: no switch or stop frame is saved,
            # and a finished row saves nothing more
            save_now = ~switch & ~stop & ~self.finished
            self.finished.logical_or_(stop & live)
            is_reason = self.is_reason & ~(switch & live)
            self.is_reason.copy_(is_reason)
            self._put(self.phase_out, torch.where(
                save_now, torch.where(is_reason, PHASE_REASON, PHASE_SEMANTIC),
                PHASE_DROPPED), live)
            self._put(self.audio_out, audio_toks, live)
            self._put(self.text_out, text_tok, live)
            self.forbid.copy_(torch.where(switch & live, ts.audio_reason_card,
                                          self.forbid))
        self._feedback(frame)
        self._advance(live)

    def _feedback(self, frame: torch.Tensor) -> None:
        """The next frame's input, copied into the static tokens and mask:
        the text token alone (text mode), or the frame rolled to the
        feedback layout [cb0..cb7, text] (audio)."""
        if self.mode == "text":
            self.tokens.zero_()
            self.tokens[:, 0, -1] = frame[:, 0]
            self.tmask.copy_(self.text_fb)
        else:
            self.tokens.copy_(frame.roll(-1, dims=1)[:, None, :])
            self.tmask.copy_(self.audio_fb)

    def _advance(self, live: torch.Tensor) -> None:
        """The position and the frame counter move on while a row is live."""
        self.pos.add_(live)
        self.step.add_(live)

    def _reset(self, first_pos: int) -> None:
        """The per-request state a run starts from: the position, the frame
        counter, the per-row flags and the outputs."""
        self.pos.fill_(first_pos)
        self.step.zero_()
        self.finished.zero_()
        self.is_reason.fill_(True)
        self.forbid.zero_()
        self.text_out.fill_(-1)
        self.audio_out.zero_()
        self.phase_out.zero_()

    def prepare(self, first_pos: int, frames: int) -> None:
        """Warm up, and on a card capture, the step of every level that the
        frames at positions [first_pos, first_pos + frames) read and that
        has none yet. Run it BEFORE the request's prefill: the warm-up step
        writes the static buffers and one cache slot, which the prefill and
        the frames overwrite before anything reads them."""
        self.warmups = 0
        first_of = {}               # level -> its first position
        for pos in range(first_pos, first_pos + frames):
            first_of.setdefault(self.level(pos), pos)
        for lvl, host_pos in first_of.items():
            if lvl not in self.graphs:
                self.graphs[lvl] = self._capture(host_pos)
                self.warmups += 1

    def _capture(self, host_pos: int):
        """Warm up: one counted frame of ``host_pos``'s level from a reset
        state (on a card on a side stream, then the capture of that frame).
        The reset matters: a kept program's last run may have left the
        frame counter at ``max_frames``, one past the outputs' last slot.
        Returns the graph and the counts of a replay (None on the CPU)."""
        t0 = time.perf_counter()
        self._reset(host_pos)
        if self.device.type != "cuda":
            with torch.no_grad():
                self._frame(host_pos)
            return None
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            self._frame(host_pos)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            captured = _cuda.capture_graph(
                lambda: self._frame(host_pos), pool=self.pool,
                generator=self.generator if self.sample["topk"] != 1
                else None)
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def run(self, tokens, tmask, first_pos: int, frames: int, *, seed=None,
            keys: Optional[torch.Tensor] = None,
            key_valid: Optional[torch.Tensor] = None):
        """Decode from the first frame's ``tokens`` / ``tmask`` (B, 1, 9) at
        ``first_pos`` for at most ``frames`` frames (the host's cap: the
        position never passes the cache, the counter never passes
        ``max_frames``), stopping at the first read of the stop flag after
        every row's EOS. The stream is the shared generator seeded with
        ``seed``, or per-row ``keys`` (B,). Returns text_out, audio_out,
        phase_out on the host, the frames with a live row and the frames
        the device ran (replays and this call's warm-ups)."""
        self.tokens.copy_(tokens)
        self.tmask.copy_(tmask)
        self._reset(first_pos)
        if self.keys is not None:
            self.keys.copy_(keys)
        elif seed is not None:
            self.generator.manual_seed(seed)
        if self.key_valid is not None:
            self.key_valid.copy_(key_valid)
        on_card = self.device.type == "cuda"
        replays = {}
        done = 0
        with torch.no_grad():
            while done < frames:
                for host_pos in range(first_pos + done,
                                      first_pos + min(done + STOP_EVERY,
                                                      frames)):
                    lvl = self.level(host_pos)
                    if on_card:
                        self.graphs[lvl][0].replay()
                        replays[lvl] = replays.get(lvl, 0) + 1
                    else:
                        self._frame(host_pos)
                    done += 1
                if bool(self.finished.all()):   # one read per STOP_EVERY
                    break
        for lvl, n in replays.items():
            _cuda.add_counts(self.graphs[lvl][1], n)
        out = (self.text_out.cpu().numpy(), self.audio_out.cpu().numpy(),
               self.phase_out.cpu().numpy())
        return (*out, int(self.step.cpu().numpy()[0]), done + self.warmups)


def pool_bytes(pool) -> Optional[int]:
    """Device bytes the caching allocator holds in the graph pool ``pool``
    (the segments of `torch.cuda.memory_snapshot` tagged with its id), or
    None where the snapshot tags no segment with a pool."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
