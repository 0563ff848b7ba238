"""Audio front end: the sinc resampler and Whisper log-mels (port of
`uniaudio2_tpu/codec/mel.py`).

* ``resample`` — torchaudio-style windowed-sinc polyphase resampler (hann
  window, lowpass_filter_width 6, rolloff 0.99) as one strided
  ``F.conv1d`` over the ``up`` phases, interleaved; the 24 kHz -> 16 kHz
  transfer of the encode path.
* ``log_mel_spectrogram`` — Whisper's recipe: 400-point hann STFT, hop
  160, reflect padding, the power spectrum with the final frame dropped,
  the Slaney mel filterbank, ``log10 -> max(., max - 8) -> (x + 4) / 4``
  with the max taken per batch row.

The filterbank, the Hann window and the resample kernel are built in
numpy, as the JAX module builds them, and copied to the input's device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE_MEL = 16000
N_FFT = 400
HOP = 160
N_MELS = 80


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-slaney convention, as used by Whisper)
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int = SAMPLE_RATE_MEL, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) slaney-normalised triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_min, mel_max = _hz_to_mel(np.array(0.0)), _hz_to_mel(np.array(sr / 2.0))
    hz_pts = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """The periodic Hann window of the JAX module, ``np.hanning(n + 1)[:-1]``."""
    return np.hanning(n + 1)[:-1].astype(np.float32)


# ---------------------------------------------------------------------------
# STFT + whisper log-mel
# ---------------------------------------------------------------------------


def log_mel_spectrogram(wav16k: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, T) 16 kHz waveform -> (B, T // HOP, n_mels) normalised log-mels
    (the usual 30 s window gives 3000 frames)."""
    half = N_FFT // 2
    x = F.pad(wav16k.float()[:, None], (half, half), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)                       # (B, n, N_FFT)
    window = torch.from_numpy(hann_window(N_FFT)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :-1, :]    # drop last frame
    fb = torch.from_numpy(mel_filterbank(SAMPLE_RATE_MEL, N_FFT, n_mels)).to(x.device)
    mel = power @ fb.T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Sinc resampler (torchaudio 'sinc_interp_hann' convention)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Polyphase kernel (up, 2 width + down) and left padding ``width``,
    torchaudio's windowed-sinc construction."""
    g = math.gcd(orig_freq, new_freq)
    up, down = new_freq // g, orig_freq // g
    base_freq = min(orig_freq, new_freq) / g * rolloff
    width = math.ceil(lowpass_filter_width * down / base_freq)
    idx = np.arange(-width, width + down, dtype=np.float64)[None] / down
    t = (-np.arange(up, dtype=np.float64)[:, None] / up + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / down
    kernel = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernel.astype(np.float32), width


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """(B, T) -> (B, ceil(T * new / orig)): for each of the ``up`` phases a
    cross-correlation with stride ``down`` (no kernel flip), the phases
    interleaved sample by sample."""
    if orig_freq == new_freq:
        return wav
    g = math.gcd(orig_freq, new_freq)
    down = orig_freq // g
    kernel, width = _resample_kernel(orig_freq, new_freq)
    t = wav.shape[-1]
    x = F.pad(wav.float(), (width, width + down))
    weight = torch.from_numpy(np.ascontiguousarray(kernel)).to(x.device)[:, None]
    out = F.conv1d(x[:, None], weight, stride=down)         # (B, up, blocks)
    out = out.transpose(1, 2).reshape(out.shape[0], -1)
    return out[:, : int(math.ceil(new_freq * t / orig_freq))]
