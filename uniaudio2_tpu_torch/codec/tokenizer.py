"""ReasoningCodec tokenizer facade: wav <-> (reasoning, reconstruction) codes
(port of `uniaudio2_tpu/codec/tokenizer.py`).

* ``tokenize(wav)`` -> (reason (8, T@5 Hz), semantic (8, T@12.5 Hz)):
  30 s windows with a 240-sample completion guard and self-repetition
  padding, the windows encoded in batches of ``batch_size`` (the tail batch
  padded with copies of its last window when there is more than one
  batch, as the JAX facade pads it for one compiled shape), concatenated
  and cut to ``duration * rate + 1`` frames.
* ``detokenize(reason, semantic)`` / ``detokenize_no_reason(semantic)`` ->
  the waveform through the windowed flow-matching decoder (`decoder.py`).

The encode runs on the device of the encode parameters. Wav files are read
and written with scipy; resampling on load is `mel.resample`, on the CPU.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from uniaudio2_tpu_torch.codec import encoder as enc
from uniaudio2_tpu_torch.codec import mel
from uniaudio2_tpu_torch.codec.decoder import CodecConfig, CodecDecoder
from uniaudio2_tpu_torch.codec.encoder import EncoderConfig


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Read a wav file -> float32 mono (T,) at ``target_sr``."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        data = mel.resample(torch.from_numpy(data)[None], sr, target_sr)[0].numpy()
    return data


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wav = np.asarray(wav, np.float32).reshape(-1)
    wavfile.write(path, sr, np.clip(wav, -1.0, 1.0))


class ReasoningCodecTokenizer:
    """Tokenizer facade over the encode and decode paths."""

    GUARD_SAMPLES = 240  # completion guard

    def __init__(self, encode_params, decode_params, enc_cfg: EncoderConfig,
                 codec_cfg: CodecConfig, *, min_duration: float = 30.0):
        self.enc_params = encode_params
        self.enc_cfg = enc_cfg
        self.cfg = codec_cfg
        self.min_duration = min_duration
        self.decoder = (CodecDecoder(decode_params, codec_cfg)
                        if decode_params is not None else None)
        self.device = (None if encode_params is None
                       else encode_params["reasoning"]["cls_token"].device)

    @property
    def is_discrete(self) -> bool:
        return True

    def _window_encode(self, windows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        with torch.no_grad():
            wav = torch.as_tensor(windows, dtype=torch.float32, device=self.device)
            reason, rec = enc.encode_window(self.enc_params, self.enc_cfg, self.cfg, wav)
        return reason.cpu().numpy(), rec.cpu().numpy()

    def windows(self, audio: np.ndarray) -> np.ndarray:
        """(T,) audio at the codec rate -> the (n_win, win) windows that
        `tokenize` encodes: the clip repeated to one window, then the
        doubled clip cut to whole windows of ``min_duration`` plus the
        guard."""
        win = int(self.min_duration * self.cfg.sample_rate) + self.GUARD_SAMPLES
        while audio.shape[-1] < win:
            audio = np.concatenate([audio, audio], -1)
        n_win = audio.shape[-1] // (win - self.GUARD_SAMPLES) + 1
        return np.concatenate([audio, audio], -1)[: n_win * win].reshape(n_win, win)

    def tokenize(self, wav: Union[str, np.ndarray], *, batch_size: int = 6
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """wav path or (T,) float array -> (reason (8, T1), semantic (8, T2))
        int64."""
        sr = self.cfg.sample_rate
        if isinstance(wav, str):
            audio = load_wav(wav, sr)
        else:
            audio = np.asarray(wav, np.float32).reshape(-1)
        orig_len = audio.shape[-1]
        out_len = int(orig_len / sr * self.cfg.rec_hz) + 1
        out_len_reason = int(orig_len / sr * self.cfg.reason_hz) + 1
        windows = self.windows(audio)
        n_win = windows.shape[0]

        reason_list, rec_list = [], []
        for i in range(0, n_win, batch_size):
            chunk = windows[i: i + batch_size]
            real = chunk.shape[0]
            if real < batch_size and n_win > batch_size:
                pad = np.repeat(chunk[-1:], batch_size - real, axis=0)
                chunk = np.concatenate([chunk, pad], 0)
            r, c = self._window_encode(chunk)
            reason_list.append(r[:real])
            rec_list.append(c[:real])
        reason = np.concatenate(reason_list, 0).reshape(-1, 8)[:out_len_reason]
        rec = np.concatenate(rec_list, 0).reshape(-1, 8)[:out_len]
        return reason.T.astype(np.int64), rec.T.astype(np.int64)

    def detokenize(self, reason: np.ndarray, semantic: np.ndarray, *, steps: int = 50,
                   guidance_scale: float = 1.5, seed: int = 0) -> np.ndarray:
        if self.decoder is None:
            raise ValueError("detokenize needs decode params or a decoder")
        return self.decoder.decode(semantic, reason, num_steps=steps,
                                   guidance_scale=guidance_scale, seed=seed)

    def detokenize_no_reason(self, semantic: np.ndarray, *, steps: int = 50,
                             guidance_scale: float = 1.5, seed: int = 0) -> np.ndarray:
        if self.decoder is None:
            raise ValueError("detokenize needs decode params or a decoder")
        return self.decoder.decode(semantic, None, num_steps=steps,
                                   guidance_scale=guidance_scale, seed=seed)

    def find_length(self, codes: np.ndarray) -> int:
        return int(codes.shape[-1])
