"""Plain PyTorch version of decode attention over a Q4_0 KV cache: the
HOST backend and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

from repro_torch.kernels.q8_attention.plain import attend, flat_cache_call
from repro_torch.quantize import QBLOCK, unpack_q4


def dequant(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """packed: (..., S, D // 2) uint8; scale: (..., S, D // 32) -> f32."""
    codes = unpack_q4(packed, axis=-1).to(torch.float32)
    return codes * scale.to(torch.float32).repeat_interleave(QBLOCK, dim=-1)


def q4_decode_attention(q, kp, ks, vp, vs, length) -> torch.Tensor:
    """q: (BH, Q, D); nibble-packed uint8 planes (BH, S, D // 2) with f16
    scales (BH, S, D // 32); query (i, j) attends positions [0, length)
    with ``length`` a scalar, (BH,) or (BH, Q). A query of length 0
    returns 0."""
    return attend(q, dequant(kp, ks), dequant(vp, vs), length)


def q4_decode_attention_cache(q, kp, ks, vp, vs, lens, layer: int):
    """The same function over one layer of the serving engine's stacked
    cache: q (B, Q, H, D); planes (L, B, S, Hkv, .); lens (B,) or (B, Q).
    Returns (B, Q, H, D)."""
    return flat_cache_call(q4_decode_attention, q, kp, ks, vp, vs, lens,
                           layer)
