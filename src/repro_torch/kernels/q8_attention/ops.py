"""Wrapper of the Q8_0 decode-attention kernel (``csrc/q8_attention.cu``).

Two entry points launch the one kernel:

* ``q8_decode_attention(q, kq, ks, vq, vs, length)`` keeps the
  reference's signature: q (BH, Q, D), code planes (BH, S, D), scales
  (BH, S, D // 32), ``length`` a scalar, (BH,) or (BH, Q);
* ``q8_decode_attention_cache(q, kq, ks, vq, vs, lens, layer)`` reads one
  layer of the serving engine's stacked (L, B, S, Hkv, .) cache planes in
  place: q (B, Q, H, D), lens (B,) or (B, Q). The kernel takes the
  planes' strides and the layer's base pointer, so no repeat, transpose
  or copy of the cache runs per step.

Q is 1 in plain decode and ``spec_k`` in the speculative verify, whose
token j attends [0, pos + j] (a (B, Q) length). On CUDA tensors they
launch the kernel; on CPU tensors they run the plain version.
``cache_traffic_ratio`` is the Q8_0 cache stream relative to bf16 (the
paper's C1 LOAD saving on the decode bottleneck).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, decode
from repro_torch.kernels.q8_attention import plain
from repro_torch.quantize import QBLOCK

_NAME = "q8_decode_attention"


def cache_traffic_ratio() -> float:
    """Q8 cache bytes per element vs bf16."""
    return (1.0 + 2.0 / QBLOCK) / 2.0


def _check_planes(q, kq, ks, vq, vs, d: int) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{_NAME}: q must be bf16, got {q.dtype}")
    if kq.shape != vq.shape or ks.shape != vs.shape:
        raise ValueError(f"{_NAME}: K/V planes differ: "
                         f"{tuple(kq.shape)} vs {tuple(vq.shape)}")
    if kq.shape[-1] != d or ks.shape[:-1] != kq.shape[:-1] \
            or ks.shape[-1] * QBLOCK != d:
        raise ValueError(f"{_NAME}: codes {tuple(kq.shape)} and scales "
                         f"{tuple(ks.shape)} do not fit head_dim {d}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or ks.dtype != torch.float16 or vs.dtype != torch.float16:
        raise TypeError(f"{_NAME}: codes must be int8 and scales f16")
    if d % QBLOCK or d > decode.D_MAX:
        raise ValueError(f"{_NAME}: head_dim {d} must be a multiple of "
                         f"{QBLOCK} and at most {decode.D_MAX}")


def q8_decode_attention(q, kq, ks, vq, vs, length) -> torch.Tensor:
    """q: (BH, Q, D); kq/vq: (BH, S, D) int8; ks/vs: (BH, S, D // 32)
    f16; query (i, j) attends [0, length[i] or length[i, j]). Returns
    (BH, Q, D) in q's dtype."""
    if q.dim() != 3 or kq.dim() != 3 or kq.shape[0] != q.shape[0]:
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and codes "
                         f"{tuple(kq.shape)} are not (BH, Q, D), (BH, S, D)")
    bh, nq, d = q.shape
    _check_planes(q, kq, ks, vq, vs, d)
    lens = decode.lens_table(length, bh, nq, q.device, _NAME)
    if not q.is_cuda:
        return plain.q8_decode_attention(q, kq, ks, vq, vs, lens)
    build.require_cuda(_NAME, q, kq, ks, vq, vs)
    q, kq, ks, vq, vs = (t.contiguous() for t in (q, kq, ks, vq, vs))
    s_len = kq.shape[1]
    out = torch.empty_like(q)
    decode.launch("q8_attention", _NAME, q, (nq * d, d, 0), kq, vq,
                  (s_len * d, d, 0), ks, vs,
                  (s_len * (d // QBLOCK), d // QBLOCK, 0), lens, out,
                  (nq * d, d, 0), bh, nq, 1, 1, s_len, d)
    q8_decode_attention.launches += 1
    return out


def q8_decode_attention_cache(q, kq, ks, vq, vs, lens,
                              layer: int) -> torch.Tensor:
    """q: (B, Q, H, D); kq/vq: (L, B, S, Hkv, D) int8; ks/vs:
    (L, B, S, Hkv, D // 32) f16; lens: (B,) or (B, Q). Attends layer
    ``layer`` of the stacked cache. Returns (B, Q, H, D) in q's dtype."""
    if q.dim() != 4 or kq.dim() != 5 or kq.shape[1] != q.shape[0] \
            or q.shape[2] % kq.shape[3]:
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and stacked codes "
                         f"{tuple(kq.shape)} are not (B, Q, H, D), "
                         f"(L, B, S, Hkv, D)")
    if not 0 <= layer < kq.shape[0]:
        raise ValueError(f"{_NAME}: layer {layer} outside "
                         f"[0, {kq.shape[0]})")
    b, nq, h, d = q.shape
    _check_planes(q, kq, ks, vq, vs, d)
    lens = decode.lens_table(lens, b, nq, q.device, _NAME)
    if not q.is_cuda:
        return plain.q8_decode_attention_cache(q, kq, ks, vq, vs, lens,
                                               layer)
    build.require_cuda(_NAME, q, kq, ks, vq, vs)
    if kq.stride() != vq.stride() or ks.stride() != vs.stride() \
            or kq.stride(4) != 1 or ks.stride(4) != 1:
        raise ValueError(f"{_NAME}: K and V planes must share strides "
                         f"with contiguous rows")
    q = q.contiguous()
    out = torch.empty_like(q)
    k_l, v_l, ks_l, vs_l = kq[layer], vq[layer], ks[layer], vs[layer]
    decode.launch("q8_attention", _NAME, q, (nq * h * d, h * d, d), k_l,
                  v_l, k_l.stride()[:3], ks_l, vs_l, ks_l.stride()[:3],
                  lens, out, (nq * h * d, h * d, d), b, nq, h, kq.shape[3],
                  kq.shape[2], d)
    q8_decode_attention.launches += 1
    return out


q8_decode_attention.launches = 0
