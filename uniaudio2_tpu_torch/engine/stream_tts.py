"""Streaming TTS: text in, waveform chunks out, incrementally (port of
`uniaudio2_tpu/engine/stream_tts.py`).

The two halves of offline TTS run as a pipeline:

* the LLM half streams frames segment by segment from a single-row
  `ContinuousEngine` (`engine/continuous.py::stream`);
* semantic-phase frames feed a `StreamingCodecDecoder`
  (`codec/streaming_decoder.py`), which solves a codec window as soon as
  its tokens have arrived and emits the finalized waveform prefix.

Time to first audio is then the reasoning phase + one codec window of
semantic frames + one window solve, not the whole utterance. The
concatenated stream equals the offline pipeline (greedy tokens, then
`CodecDecoder.decode` with the same seed) bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from uniaudio2_tpu_torch.codec.decoder import NoiseFn
from uniaudio2_tpu_torch.codec.streaming_decoder import StreamingCodecDecoder
from uniaudio2_tpu_torch.engine.decode import PHASE_SEMANTIC


def stream_tts(
    llm_engine,                 # ContinuousEngine (mode="audio", rows=1)
    codec_params,
    codec_cfg,
    grid: np.ndarray,
    mask: np.ndarray,
    *,
    max_frames: Optional[int] = None,
    num_steps: int = 10,
    guidance_scale: float = 1.5,
    codec_seed: int = 0,
    window_seconds: Optional[float] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> Iterator[np.ndarray]:
    """Yield finalized waveform chunks (1, n) float32 as generation
    proceeds. ``grid`` / ``mask`` come from `engine/tasks.py::prepare_tts`.

    ``window_seconds`` overrides the codec's window for this stream (the
    low-latency profile: time to first audio is dominated by filling the
    first window, 30 s x 12.5 Hz = 375 semantic frames by default); None
    keeps the offline-identical default. ``noise_fn`` replaces the codec's
    seeded noise (`StreamingCodecDecoder`), e.g. with another framework's
    draws."""
    card = llm_engine.cfg.tokens.audio_reason_card
    if window_seconds is not None:
        codec_cfg = dataclasses.replace(codec_cfg,
                                        window_seconds=float(window_seconds))
    sd = StreamingCodecDecoder(
        codec_params, codec_cfg, num_steps=num_steps,
        guidance_scale=guidance_scale, seed=codec_seed, noise_fn=noise_fn)
    first_semantic = True
    for phase, frame in llm_engine.stream(grid, mask, max_frames):
        if phase == PHASE_SEMANTIC:
            if first_semantic:
                # drop the generated semantic-BOS frame, as the offline split
                # does (`decode.split_two_phase`): its code (semantic_bos +
                # card) lies outside the codebooks and must not reach the
                # codec
                first_semantic = False
                continue
            wav = sd.feed((frame.astype(np.int64) - card)[:, None])
            if wav.shape[-1]:
                yield wav
    tail = sd.flush()
    if tail.shape[-1]:
        yield tail
