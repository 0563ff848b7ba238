"""Shared audio / token utilities (port of `uniaudio2_tpu/codec/audio_utils.py`,
numpy and scipy, the same signatures).

``clip_by_length`` (factor-aligned random crops), ``codec_specaug`` (time
masking of codes), ``speech_edit_find_time_stamp`` (the span to mask for
the speech-edit task from a phone alignment), ``loudness_lufs`` (ITU-R
BS.1770 K-weighted gated loudness) and ``VolumeNorm`` (loudness
normalisation with gain jitter and declipping), with explicit RNGs.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import lfilter


def clip_by_length(
    x: np.ndarray, length: int, factor: int = 1,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Random crop to ``length`` with the start aligned to ``factor``."""
    if len(x) <= length:
        return x
    rng = rng or random
    start = rng.randint(0, len(x) - length - 1)
    start = start // factor * factor
    return x[start : start + length]


def codec_specaug(
    codec: np.ndarray, mask_id: int, *, rng: Optional[random.Random] = None,
    n_masks: int = 5, max_frac: float = 0.05,
) -> np.ndarray:
    """Time-mask augmentation over (T, D) codes: ``n_masks`` random spans of
    up to ``max_frac``·T frames replaced by ``mask_id``."""
    rng = rng or random
    codec = np.array(codec)
    t = codec.shape[0]
    max_len = int(t * max_frac)
    if max_len > 0 and t - max_len - 1 > 0:
        for _ in range(n_masks):
            start = rng.randint(0, t - max_len - 1)
            length = rng.randint(0, max_len)
            codec[start : start + length] = mask_id
    return codec.reshape(-1)


def speech_edit_find_time_stamp(
    phones: Sequence[int], token_list: Sequence[str],
    rng: Optional[random.Random] = None,
) -> Tuple[int, int]:
    """Pick a 1-2 word span to mask from a kaldi phone-alignment sequence
    (B/I/E/S position suffixes)."""
    rng = rng or random
    phones = np.asarray(phones)
    # run-length encode
    change = np.flatnonzero(np.diff(phones)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(phones)]])
    names = [token_list[phones[s]] for s in starts]
    cum = ends.tolist()

    ans: List[Tuple[object, int]] = []
    buf: List[Tuple[str, int]] = []
    for name, count in zip(names, cum):
        if name.endswith(("_B", "_I", "_E")):
            buf.append((name, count))
            if name.endswith("_E"):
                ans.append((tuple(n for n, _ in buf), buf[-1][1]))
                buf = []
        else:
            ans.append((name, count))
    if len(ans) <= 2:
        return (0, ans[-1][1])
    num = rng.randint(1, 2)
    word_start = rng.randint(0, len(ans) - num)
    start = 0 if word_start == 0 else ans[word_start - 1][1]
    return (start, ans[word_start + num - 1][1])


# ---------------------------------------------------------------------------
# Loudness (ITU-R BS.1770-4 K-weighting, mono/stereo)
# ---------------------------------------------------------------------------


def _k_weighting_coeffs(sr: float):
    """Shelving + high-pass biquads of the K-weighting prefilter."""
    # Stage 1: high-shelf
    f0, g_db, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = math.tan(math.pi * f0 / sr)
    vh = 10 ** (g_db / 20.0)
    vb = vh ** 0.499666774155
    a0 = 1.0 + k / q + k * k
    b_shelf = [
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ]
    a_shelf = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    # Stage 2: high-pass
    f0, q = 38.13547087613982, 0.5003270373253953
    k = math.tan(math.pi * f0 / sr)
    denom = 1.0 + k / q + k * k
    b_hp = [1.0, -2.0, 1.0]
    a_hp = [1.0, 2.0 * (k * k - 1.0) / denom, (1.0 - k / q + k * k) / denom]
    return (b_shelf, a_shelf), (b_hp, a_hp)


def loudness_lufs(signal: np.ndarray, sr: int) -> float:
    """Integrated loudness (LUFS) with 400 ms gated blocks."""
    x = np.atleast_2d(np.asarray(signal, np.float64))
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sr)
    y = lfilter(bh, ah, lfilter(bs, as_, x, axis=-1), axis=-1)
    block = int(0.4 * sr)
    hop = block - int(0.1 * sr)
    if y.shape[-1] < block:
        ms = np.mean(y ** 2, axis=-1).sum()
        return -0.691 + 10 * math.log10(max(ms, 1e-12))
    n_blocks = 1 + (y.shape[-1] - block) // hop
    power = np.empty(n_blocks)
    for i in range(n_blocks):
        seg = y[:, i * hop : i * hop + block]
        power[i] = np.mean(seg ** 2, axis=-1).sum()
    lk = -0.691 + 10 * np.log10(np.maximum(power, 1e-12))
    gated = power[lk > -70.0]
    if gated.size == 0:
        return -70.0
    rel_thresh = -0.691 + 10 * math.log10(gated.mean()) - 10.0
    gated2 = power[lk > rel_thresh]
    if gated2.size == 0:
        gated2 = gated
    return -0.691 + 10 * math.log10(gated2.mean())


class VolumeNorm:
    """Loudness normalization to ``target ± jitter`` LUFS with silence guard
    and declipping (reference `VolumeNorm`, `common.py:94-140`)."""

    def __init__(self, params=(-16.0, 3.0), sample_rate: int = 24000,
                 energy_threshold: float = 1e-6, seed: Optional[int] = None):
        self.target = params[0]
        self.jitter = params[1]
        self.sr = sample_rate
        self.energy_threshold = energy_threshold
        self.rng = random.Random(seed)

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        signal = np.asarray(signal, np.float32)
        if float(np.mean(signal ** 2)) < self.energy_threshold:
            return signal
        current = loudness_lufs(signal, self.sr)
        target = self.target + self.rng.uniform(-self.jitter, self.jitter)
        gain = 10.0 ** ((target - current) / 20.0)
        out = signal * gain
        peak = float(np.max(np.abs(out)))
        if peak >= 1.0:
            out = out / peak * 0.95
        return out
