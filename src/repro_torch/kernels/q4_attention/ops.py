"""Wrapper of the Q4_0 decode-attention kernel (``csrc/q4_attention.cu``)
and the Q4_0 KV-cache helpers.

Two entry points launch the one kernel, as for the Q8_0 cache:

* ``q4_decode_attention(q, kp, ks, vp, vs, length)``: q (BH, Q, D),
  nibble-packed planes (BH, S, D // 2) uint8, scales (BH, S, D // 32)
  f16, ``length`` a scalar, (BH,) or (BH, Q);
* ``q4_decode_attention_cache(q, kp, ks, vp, vs, lens, layer)`` reads
  one layer of the serving engine's stacked (L, B, S, Hkv, .) planes in
  place: q (B, Q, H, D), lens (B,) or (B, Q).

On CUDA tensors they launch the kernel; on CPU tensors they run the plain
version. ``quantize_kv_q4`` builds the packed planes from float K/V;
``cache_traffic_ratio_q4`` is the Q4_0 cache stream relative to bf16,
(0.5 + 2/32) / 2 = 0.28125.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, decode
from repro_torch.kernels.q4_attention import plain
from repro_torch.quantize import QBLOCK, quantize_q4_0

_NAME = "q4_decode_attention"


def quantize_kv_q4(k: torch.Tensor):
    """k: (..., S, D) float -> (packed uint8 plane (..., S, D // 2),
    (..., S, D // 32) f16 scales)."""
    t = quantize_q4_0(k, axis=-1)
    return t.q, t.scale


def cache_traffic_ratio_q4() -> float:
    """Q4 cache bytes per element vs bf16: (0.5 + 2/QBLOCK) / 2."""
    return (0.5 + 2.0 / QBLOCK) / 2.0


def _check_planes(q, kp, ks, vp, vs, d: int) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{_NAME}: q must be bf16, got {q.dtype}")
    if kp.shape != vp.shape or ks.shape != vs.shape:
        raise ValueError(f"{_NAME}: K/V planes differ: "
                         f"{tuple(kp.shape)} vs {tuple(vp.shape)}")
    if 2 * kp.shape[-1] != d or ks.shape[:-1] != kp.shape[:-1] \
            or ks.shape[-1] * QBLOCK != d:
        raise ValueError(f"{_NAME}: packed codes {tuple(kp.shape)} and "
                         f"scales {tuple(ks.shape)} do not fit head_dim {d}")
    if kp.dtype != torch.uint8 or vp.dtype != torch.uint8 \
            or ks.dtype != torch.float16 or vs.dtype != torch.float16:
        raise TypeError(f"{_NAME}: codes must be uint8 and scales f16")
    if d % QBLOCK or d > decode.D_MAX:
        raise ValueError(f"{_NAME}: head_dim {d} must be a multiple of "
                         f"{QBLOCK} and at most {decode.D_MAX}")


def q4_decode_attention(q, kp, ks, vp, vs, length) -> torch.Tensor:
    """q: (BH, Q, D); kp/vp: (BH, S, D // 2) uint8; ks/vs:
    (BH, S, D // 32) f16; query (i, j) attends [0, length[i] or
    length[i, j]). Returns (BH, Q, D) in q's dtype."""
    if q.dim() != 3 or kp.dim() != 3 or kp.shape[0] != q.shape[0]:
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and packed codes "
                         f"{tuple(kp.shape)} are not (BH, Q, D), "
                         f"(BH, S, D/2)")
    bh, nq, d = q.shape
    _check_planes(q, kp, ks, vp, vs, d)
    lens = decode.lens_table(length, bh, nq, q.device, _NAME)
    if not q.is_cuda:
        return plain.q4_decode_attention(q, kp, ks, vp, vs, lens)
    build.require_cuda(_NAME, q, kp, ks, vp, vs)
    q, kp, ks, vp, vs = (t.contiguous() for t in (q, kp, ks, vp, vs))
    s_len = kp.shape[1]
    out = torch.empty_like(q)
    decode.launch("q4_attention", _NAME, q, (nq * d, d, 0), kp, vp,
                  (s_len * d // 2, d // 2, 0), ks, vs,
                  (s_len * (d // QBLOCK), d // QBLOCK, 0), lens, out,
                  (nq * d, d, 0), bh, nq, 1, 1, s_len, d)
    q4_decode_attention.launches += 1
    return out


def q4_decode_attention_cache(q, kp, ks, vp, vs, lens,
                              layer: int) -> torch.Tensor:
    """q: (B, Q, H, D); kp/vp: (L, B, S, Hkv, D // 2) uint8; ks/vs:
    (L, B, S, Hkv, D // 32) f16; lens: (B,) or (B, Q). Attends layer
    ``layer`` of the stacked cache. Returns (B, Q, H, D) in q's dtype."""
    if q.dim() != 4 or kp.dim() != 5 or kp.shape[1] != q.shape[0] \
            or q.shape[2] % kp.shape[3]:
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and stacked packed "
                         f"codes {tuple(kp.shape)} are not (B, Q, H, D), "
                         f"(L, B, S, Hkv, D/2)")
    if not 0 <= layer < kp.shape[0]:
        raise ValueError(f"{_NAME}: layer {layer} outside "
                         f"[0, {kp.shape[0]})")
    b, nq, h, d = q.shape
    _check_planes(q, kp, ks, vp, vs, d)
    lens = decode.lens_table(lens, b, nq, q.device, _NAME)
    if not q.is_cuda:
        return plain.q4_decode_attention_cache(q, kp, ks, vp, vs, lens,
                                               layer)
    build.require_cuda(_NAME, q, kp, ks, vp, vs)
    if kp.stride() != vp.stride() or ks.stride() != vs.stride() \
            or kp.stride(4) != 1 or ks.stride(4) != 1:
        raise ValueError(f"{_NAME}: K and V planes must share strides "
                         f"with contiguous rows")
    q = q.contiguous()
    out = torch.empty_like(q)
    k_l, v_l, ks_l, vs_l = kp[layer], vp[layer], ks[layer], vs[layer]
    decode.launch("q4_attention", _NAME, q, (nq * h * d, h * d, d), k_l,
                  v_l, k_l.stride()[:3], ks_l, vs_l, ks_l.stride()[:3],
                  lens, out, (nq * h * d, h * d, d), b, nq, h, kp.shape[3],
                  kp.shape[2], d)
    q4_decode_attention.launches += 1
    return out


q4_decode_attention.launches = 0
