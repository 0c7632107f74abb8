"""Encoder chunking and the synthetic test waveform.

The port of ``chunk_list`` and ``synth_waveform`` from the JAX
package's ``audio/stream.py``; ``StreamingFrontend`` is not ported yet
(ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import List

import numpy as np


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
