"""Whisper-style log-mel frontend in PyTorch + a NumPy golden reference.

The port of the JAX package's ``audio/features.py``: samples (float32,
16 kHz) are framed (no center padding, zero-padded tail), windowed
(periodic Hann) and transformed (``torch.fft.rfft``); the power spectrum
goes through the mel filterbank, then ``log10``, a fixed floor of -8 and
the ``(x + 4) / 4`` normalisation; ``mel_to_frames`` pools pairs of mel
frames and applies the fixed cosine projection and an exact GELU.

The mel-filterbank GEMM and the projection GEMM run through
``dispatch("fp16_matmul", ..., tag="frontend")`` with f32 operands, so
the control law and the dispatch accounting see them like every other
GEMM of the model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.api import dispatch
from repro_torch.platforms import resolve_device

SAMPLE_RATE = 16_000

LOG_FLOOR = -8.0       # fixed dynamic-range floor (log10 units)
MEL_EPS = 1e-10


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Whisper's frontend constants (25 ms window / 10 ms hop at 16 kHz)."""

    sample_rate: int = SAMPLE_RATE
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None   # None -> sample_rate / 2
    stride: int = 2                # temporal pooling of the conv-stem stand-in

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1

    def n_frames(self, n_samples: int) -> int:
        """Mel frames for ``n_samples``: one per started hop."""
        return -(-n_samples // self.hop) if n_samples > 0 else 0

    def n_embed_frames(self, n_samples: int) -> int:
        """Frame embeddings after the stride-``stride`` pooling."""
        return -(-self.n_frames(n_samples) // self.stride)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)) \
        .astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_cached(n_mels: int, n_fft: int, sr: int, fmin: float,
                           fmax: float) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                n_mels + 2))
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float64)
    for m in range(n_mels):
        lo, center, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / max(center - lo, 1e-9)
        down = (hi - freqs) / max(hi - center, 1e-9)
        tri = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] = tri * (2.0 / max(hi - lo, 1e-9))   # slaney area norm
    fb = fb.astype(np.float32)
    fb.flags.writeable = False
    return fb


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """(n_freq, n_mels) triangular HTK-mel filterbank, slaney-normalized."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    return _mel_filterbank_cached(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                                  float(cfg.fmin), float(fmax))


def _frame_signal_np(samples, cfg: FrontendConfig) -> np.ndarray:
    """(T, n_fft) frame matrix; the last frame is zero-padded."""
    x = np.asarray(samples, np.float32).reshape(-1)
    t = cfg.n_frames(len(x))
    if t == 0:
        return np.zeros((0, cfg.n_fft), np.float32)
    need = (t - 1) * cfg.hop + cfg.n_fft
    if need > len(x):
        x = np.pad(x, (0, need - len(x)))
    idx = (np.arange(t) * cfg.hop)[:, None] + np.arange(cfg.n_fft)
    return x[idx]


def log_mel(samples, cfg: FrontendConfig = FrontendConfig(), *,
            device=None) -> torch.Tensor:
    """Log-mel spectrogram (T, n_mels), float32, on ``device``."""
    dev = resolve_device(device)
    frames = torch.from_numpy(_frame_signal_np(samples, cfg)).to(dev)
    if frames.shape[0] == 0:
        return torch.zeros((0, cfg.n_mels), dtype=torch.float32, device=dev)
    win = torch.from_numpy(hann_window(cfg.n_fft)).to(dev)
    spec = torch.fft.rfft(frames * win[None, :], dim=-1)
    power = (spec.abs() ** 2).to(torch.float32).contiguous()
    fb = torch.from_numpy(mel_filterbank(cfg).copy()).to(dev)
    mel = dispatch("fp16_matmul", power, fb, out_dtype=torch.float32,
                   tag="frontend")
    log_spec = torch.log10(torch.clamp(mel, min=MEL_EPS))
    log_spec = torch.clamp(log_spec, min=LOG_FLOOR)
    return ((log_spec + 4.0) / 4.0).to(torch.float32)


def log_mel_ref(samples, cfg: FrontendConfig = FrontendConfig()) -> np.ndarray:
    """NumPy golden reference for ``log_mel`` (same math, np.fft)."""
    frames = _frame_signal_np(samples, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.n_mels), np.float32)
    spec = np.fft.rfft(frames * hann_window(cfg.n_fft)[None, :], axis=-1)
    power = (np.abs(spec) ** 2).astype(np.float32)
    mel = power @ mel_filterbank(cfg)
    log_spec = np.log10(np.maximum(mel, MEL_EPS))
    log_spec = np.maximum(log_spec, LOG_FLOOR)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _cosine_projection(n_mels: int, d_model: int) -> np.ndarray:
    """Deterministic (n_mels, d_model) DCT-like projection — the
    conv-stem stand-in's mixing matrix (no trained weights exist)."""
    m = np.arange(n_mels, dtype=np.float64)[:, None]
    j = np.arange(d_model, dtype=np.float64)[None, :]
    p = np.cos(np.pi * (m + 0.5) * (j + 1.0) / n_mels)
    p = (p * math.sqrt(2.0 / n_mels)).astype(np.float32)
    p.flags.writeable = False
    return p


@functools.lru_cache(maxsize=8)
def _projection_on(n_mels: int, d_model: int,
                   device: torch.device) -> torch.Tensor:
    """``_cosine_projection`` on ``device``, copied there once: a copy a
    call would wait on the device at every frontend call."""
    return torch.from_numpy(_cosine_projection(n_mels, d_model).copy()) \
        .to(device)


def mel_to_frames(logmel: torch.Tensor, d_model: int,
                  cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Log-mel (T, n_mels) -> frame embeddings (ceil(T / stride),
    d_model) on logmel's device: stride-mean pooling, the fixed cosine
    projection (dispatched, tagged ``frontend``) and an exact GELU."""
    x = logmel.to(torch.float32)
    t = x.shape[0]
    s = cfg.stride
    tp = -(-t // s) if t else 0
    if tp == 0:
        return torch.zeros((0, d_model), dtype=torch.float32,
                           device=x.device)
    if tp * s > t:
        x = torch.nn.functional.pad(x, (0, 0, 0, tp * s - t))
    pooled = x.reshape(tp, s, cfg.n_mels).mean(dim=1)
    y = dispatch("fp16_matmul", pooled,
                 _projection_on(cfg.n_mels, d_model, x.device),
                 out_dtype=torch.float32, tag="frontend")
    return torch.nn.functional.gelu(y, approximate="none")


def audio_frames(samples, d_model: int,
                 cfg: FrontendConfig = FrontendConfig(), *,
                 device=None) -> torch.Tensor:
    """samples -> (n_embed_frames, d_model) encoder frame embeddings."""
    return mel_to_frames(log_mel(samples, cfg, device=device), d_model, cfg)


def resample_linear(samples, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (NumPy)."""
    x = np.asarray(samples, np.float32).reshape(-1)
    if sr_in == sr_out or len(x) == 0:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64),
                     x).astype(np.float32)
