"""Streaming audio frontend, encoder chunking and the synthetic test
waveform (the JAX package's ``audio/stream.py``).

``StreamingFrontend`` accepts audio in arbitrary-size pushes and emits
encoder frame embeddings *incrementally*, guaranteeing that

    concat(push(c) for c in chunks) + flush()  ==  audio_frames(audio)

bit for bit: a mel frame is emitted only once its full ``n_fft`` sample
window has arrived (the frontend holds ``n_fft - hop`` samples of
lookback), and embedding frames are emitted in whole stride groups so
the temporal pooling sees the same row groups as the one-shot path.
``flush()`` zero-pads the tail exactly as ``features.log_mel`` does.
Every stage of the frontend computes a row from its own inputs only
(the two f32 products sum each output over k in order, on the card and
on the CPU), so a push's few rows come out with the bits the one-shot
path gives them among thousands.

The encoder-chunk streaming (fixed-size chunks, block-diagonal
attention, in-place cross-K/V extension) lives in ``serving.engine``
(``open_stream`` / ``stream_feed``); this module is frontend only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.audio.features import FrontendConfig, log_mel, mel_to_frames
from repro_torch.platforms import resolve_device


class StreamingFrontend:
    """Incremental ``audio_frames``: push samples, get frame embeddings.

    ``push`` returns the newly completed (k, d_model) embedding frames
    (possibly none) as an f32 tensor on the frontend's ``device``
    (default ``cuda``); ``flush`` pads and emits the tail. The
    concatenation of all outputs equals the one-shot
    ``features.audio_frames`` on the same samples, exactly."""

    def __init__(self, d_model: int,
                 cfg: FrontendConfig = FrontendConfig(), *, device=None):
        self.cfg = cfg
        self.d_model = d_model
        self.device = resolve_device(device)
        self._buf = np.zeros(0, np.float32)   # samples from _mel_done*hop on
        self._total = 0                       # samples received
        self._mel_done = 0                    # emitted mel frames (k*stride)
        self._closed = False

    @property
    def samples_received(self) -> int:
        return self._total

    @property
    def frames_emitted(self) -> int:
        """Embedding frames emitted so far."""
        return self._mel_done // self.cfg.stride

    def _none(self) -> torch.Tensor:
        return torch.zeros((0, self.d_model), dtype=torch.float32,
                           device=self.device)

    def push(self, samples) -> torch.Tensor:
        """Feed more samples; returns the newly final embedding frames
        ((k, d_model), k >= 0)."""
        if self._closed:
            raise ValueError("push() after flush()")
        cfg = self.cfg
        x = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._total += len(x)
        # mel frame t is final once t*hop + n_fft samples have arrived
        complete = 0 if self._total < cfg.n_fft \
            else (self._total - cfg.n_fft) // cfg.hop + 1
        m1 = (complete // cfg.stride) * cfg.stride   # whole stride groups
        if m1 <= self._mel_done:
            return self._none()
        # samples of mel frames [_mel_done, m1), relative to the buffer
        # (which starts at global offset _mel_done * hop)
        n_new = m1 - self._mel_done
        end = (n_new - 1) * cfg.hop + cfg.n_fft
        lm = log_mel(self._buf[:end], cfg, device=self.device)[:n_new]
        out = mel_to_frames(lm, self.d_model, cfg)
        self._buf = self._buf[n_new * cfg.hop:]
        self._mel_done = m1
        return out

    def flush(self) -> torch.Tensor:
        """End of stream: emit the remaining (zero-padded) tail frames."""
        if self._closed:
            return self._none()
        self._closed = True
        remaining = self.cfg.n_frames(self._total) - self._mel_done
        if remaining <= 0:
            return self._none()
        lm = log_mel(self._buf, self.cfg, device=self.device)
        if lm.shape[0] != remaining:
            raise AssertionError(f"flush: {lm.shape[0]} mel frames, "
                                 f"{remaining} expected")
        out = mel_to_frames(lm, self.d_model, self.cfg)
        self._buf = np.zeros(0, np.float32)
        self._mel_done += remaining
        return out


def chunk_list(frames, chunk: int) -> List:
    """Split (T, d) frames into fixed-size encoder chunks (last
    partial). Works on numpy arrays and tensors alike."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return [frames[i:i + chunk] for i in range(0, frames.shape[0], chunk)]


def synth_waveform(seconds: float = 1.0, sr: int = 16_000,
                   seed: int = 0) -> np.ndarray:
    """Deterministic synthetic test waveform: two tones + a chirp +
    light noise, peak-normalized (the same samples as the reference)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)
         + 0.3 * np.sin(2 * np.pi * 440.0 * t + 0.7)
         + 0.2 * np.sin(2 * np.pi * (300.0 + 600.0 * t) * t)
         + 0.05 * rng.standard_normal(t.shape))
    peak = np.abs(x).max() or 1.0
    return (x / peak * 0.8).astype(np.float32)
