"""Incremental codec decode: feed rec tokens as they are generated, get
waveform pieces back (port of `uniaudio2_tpu/codec/streaming_decoder.py`).

Runs `CodecDecoder.decode`'s window schedule online: a window solves as
soon as its tokens have arrived, and the waveform that can no longer change
(everything before the next window's crossfade) is returned at once. The
output equals the offline decode's: the same window boundaries, the same
noise sequence (one generator seeded with ``seed``, drawn in window order,
or the same ``noise_fn``), the same repeat-padding of the last partial
window at `flush`. A clip that never fills the first window is handed whole
to the offline decode at `flush`, which picks its fractional window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from uniaudio2_tpu_torch.codec.decoder import (
    CodecConfig, CodecDecoder, NoiseFn, _pad_to_hops,
)


class StreamingCodecDecoder:
    """Usage:
        sd = StreamingCodecDecoder(params, cfg, seed=0)
        for frames in token_stream:          # (8, k) int arrays
            wav = sd.feed(frames)            # (1, n) float32 (n may be 0)
        wav = sd.flush()                     # the remaining samples
    """

    def __init__(self, params, cfg: CodecConfig, *, num_steps: int = 10,
                 guidance_scale: float = 1.5, seed: int = 0,
                 noise_fn: Optional[NoiseFn] = None,
                 decoder: Optional[CodecDecoder] = None):
        # ``decoder`` lets successive streams share one CodecDecoder (and
        # its prepared weights); a StreamingCodecDecoder is single-use
        self._dec = decoder if decoder is not None else CodecDecoder(params, cfg)
        self.cfg = cfg
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self._seed = seed
        self._noise_fn = noise_fn
        self._gen = torch.Generator(device=self._dec.device).manual_seed(seed)

        self._win = cfg.window_rec_frames
        self._hop = self._win // 4 * 3
        self._win_samp = int(cfg.window_seconds * cfg.sample_rate)
        self._ovlp_samp = self._win_samp - self._win_samp // 4 * 3

        self._ncb = cfg.num_codebooks
        self._buf = np.zeros((0, self._ncb), np.int64)   # frame-major codes
        self._n_fed = 0
        self._chunks = 0
        self._emitted = 0
        self._prev_latent: Optional[torch.Tensor] = None
        self._tail: Optional[np.ndarray] = None          # pending overlap
        self._flushed = False

    def _solve_chunk(self, rec_win: np.ndarray) -> np.ndarray:
        """One window solve + ScalarAE decode -> (1, win_samp) f32."""
        noise = self._dec._noise(self._gen, self._noise_fn, self._chunks,
                                 (1, 2 * self._win, self.cfg.latent_dim))
        lat = self._dec._solve(self.cfg, rec_win[None], None, self._prev_latent,
                               noise, self.num_steps, self.guidance_scale)
        self._prev_latent = lat
        self._chunks += 1
        return self._dec._waveform(self.cfg, lat)

    def _emit(self, wav: np.ndarray) -> np.ndarray:
        """Crossfade against the pending tail; return the samples that are
        now final, holding back this window's overlap tail."""
        if self._tail is None:
            out = wav[:, : -self._ovlp_samp]
        else:
            ramp = np.linspace(0, 1, self._ovlp_samp, dtype=np.float32)[None]
            head = self._tail * (1.0 - ramp) + wav[:, : self._ovlp_samp] * ramp
            out = np.concatenate(
                [head, wav[:, self._ovlp_samp: -self._ovlp_samp]], axis=-1)
        self._tail = wav[:, -self._ovlp_samp:]
        return out

    def _run(self, buf: np.ndarray) -> list:
        outs = []
        while buf.shape[0] >= self._chunks * self._hop + self._win:
            s = self._chunks * self._hop
            outs.append(self._emit(self._solve_chunk(buf[s: s + self._win])))
        return outs

    def feed(self, codes: np.ndarray) -> np.ndarray:
        """Append rec codes (8, k), codebook-major; returns the newly final
        waveform samples (1, n), n possibly 0."""
        if self._flushed:
            raise RuntimeError("feed() after flush()")
        codes = np.asarray(codes, np.int64)
        if codes.ndim != 2 or codes.shape[0] != self._ncb:
            raise ValueError(f"feed: codes must be ({self._ncb}, k), got "
                             f"{codes.shape}")
        self._buf = np.concatenate([self._buf, codes.T], axis=0)
        self._n_fed += codes.shape[1]
        outs = self._run(self._buf)
        out = (np.concatenate(outs, axis=-1) if outs
               else np.zeros((1, 0), np.float32))
        self._emitted += out.shape[-1]
        return out

    def flush(self) -> np.ndarray:
        """Repeat-pad the last partial window as the offline decode does,
        solve what remains and return every remaining sample, trimmed to
        the true audio length."""
        if self._flushed:
            raise RuntimeError("flush() called twice")
        self._flushed = True
        if self._n_fed == 0:
            return np.zeros((1, 0), np.float32)
        cfg = self.cfg
        if self._chunks == 0:
            wav = self._dec.decode(
                self._buf.T, num_steps=self.num_steps,
                guidance_scale=self.guidance_scale, seed=self._seed,
                noise_fn=self._noise_fn)
            self._emitted += wav.shape[-1]
            return wav
        target = int(self._n_fed / cfg.rec_hz * cfg.sample_rate)
        outs = self._run(_pad_to_hops(self._buf[None], self._win)[0])
        if self._tail is not None:
            outs.append(self._tail)
            self._tail = None
        out = (np.concatenate(outs, axis=-1) if outs
               else np.zeros((1, 0), np.float32))
        out = out[:, : max(0, target - self._emitted)]
        self._emitted += out.shape[-1]
        return out

    @property
    def samples_emitted(self) -> int:
        return self._emitted
