"""Wrapper of the Q8_0 decode-attention kernel (``csrc/q8_attention.cu``).

Two entry points launch the one kernel:

* ``q8_decode_attention(q, kq, ks, vq, vs, length)`` keeps the
  reference's signature: q (BH, 1, D), code planes (BH, S, D), scales
  (BH, S, D // 32), ``length`` a scalar or (BH,);
* ``q8_decode_attention_cache(q, kq, ks, vq, vs, lens, layer)`` reads one
  layer of the serving engine's stacked (L, B, S, Hkv, .) cache planes in
  place: q (B, 1, H, D), lens (B,). The kernel takes the planes' strides
  and the layer's base pointer, so no repeat, transpose or copy of the
  cache runs per step.

On CUDA tensors they launch the kernel; on CPU tensors they run the plain
version. ``cache_traffic_ratio`` is the Q8_0 cache stream relative to
bf16 (the paper's C1 LOAD saving on the decode bottleneck).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q8_attention import plain
from repro_torch.quantize import QBLOCK

_LL = ctypes.c_longlong
_P = ctypes.c_void_p
_ARGTYPES = ([_P, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL,
              _P, _P, _LL, _LL] + [ctypes.c_int] * 5 + [_P])

#: bytes of shared memory one block may use on Hopper
_SMEM_LIMIT = 232_448
_NT = 128


def _lib():
    lib = build.load("q8_attention")
    lib.q8_decode_attention.argtypes = _ARGTYPES
    lib.q8_decode_attention.restype = ctypes.c_int
    return lib


def cache_traffic_ratio() -> float:
    """Q8 cache bytes per element vs bf16."""
    return (1.0 + 2.0 / QBLOCK) / 2.0


def _check_planes(q, kq, ks, vq, vs, d: int) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q8_decode_attention: q must be bf16, got "
                        f"{q.dtype}")
    if kq.shape != vq.shape or ks.shape != vs.shape:
        raise ValueError(f"q8_decode_attention: K/V planes differ: "
                         f"{tuple(kq.shape)} vs {tuple(vq.shape)}")
    if kq.shape[-1] != d or ks.shape[:-1] != kq.shape[:-1] \
            or ks.shape[-1] * QBLOCK != d:
        raise ValueError(f"q8_decode_attention: codes {tuple(kq.shape)} "
                         f"and scales {tuple(ks.shape)} do not fit "
                         f"head_dim {d}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or ks.dtype != torch.float16 or vs.dtype != torch.float16:
        raise TypeError("q8_decode_attention: codes must be int8 and "
                        "scales f16")
    if d % QBLOCK or d > 128:
        raise ValueError(f"q8_decode_attention: head_dim {d} must be a "
                         f"multiple of {QBLOCK} and at most 128")


def _launch(q, q_sb, q_sh, kq, vq, kv_strides, ks, vs, sc_strides, lens,
            out, o_sb, o_sh, b, h, hkv, s_len, d) -> None:
    """Launch over lanes b, heads h; strides in elements of each plane."""
    if (d + s_len + 4 + _NT) * 4 > _SMEM_LIMIT:
        raise ValueError(f"q8_decode_attention: S={s_len} scores exceed "
                         f"the shared memory of one block")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16 \
            or any(st % 16 for st in kv_strides):
        raise ValueError("q8_decode_attention: code rows must be 16-byte "
                         "aligned")
    rc = _lib().q8_decode_attention(
        q.data_ptr(), q_sb, q_sh, kq.data_ptr(), vq.data_ptr(),
        *kv_strides, ks.data_ptr(), vs.data_ptr(), *sc_strides,
        lens.data_ptr(), out.data_ptr(), o_sb, o_sh, b, h, hkv, s_len, d,
        build.stream(q.device))
    build.check(rc, "q8_attention")
    q8_decode_attention.launches += 1


def _lens(length, n: int, device) -> torch.Tensor:
    lens = torch.as_tensor(length, device=device)
    if lens.dim() > 1 or (lens.dim() == 1 and lens.shape[0] not in (1, n)):
        raise ValueError(f"q8_decode_attention: length of shape "
                         f"{tuple(lens.shape)} for {n} lanes")
    return lens.to(torch.int32).reshape(-1).expand(n).contiguous()


def q8_decode_attention(q, kq, ks, vq, vs, length) -> torch.Tensor:
    """q: (BH, 1, D); kq/vq: (BH, S, D) int8; ks/vs: (BH, S, D // 32) f16;
    lane i attends [0, length[i]). Returns (BH, 1, D) in q's dtype."""
    if q.dim() != 3 or q.shape[1] != 1 or kq.dim() != 3 \
            or kq.shape[0] != q.shape[0]:
        raise ValueError(f"q8_decode_attention: q {tuple(q.shape)} and "
                         f"codes {tuple(kq.shape)} are not (BH, 1, D), "
                         f"(BH, S, D)")
    bh, _, d = q.shape
    _check_planes(q, kq, ks, vq, vs, d)
    if not q.is_cuda:
        return plain.q8_decode_attention(q, kq, ks, vq, vs, length)
    build.require_cuda("q8_decode_attention", q, kq, ks, vq, vs)
    q, kq, ks, vq, vs = (t.contiguous() for t in (q, kq, ks, vq, vs))
    s_len = kq.shape[1]
    out = torch.empty_like(q)
    _launch(q, d, 0, kq, vq, (s_len * d, d, 0), ks, vs,
            (s_len * (d // QBLOCK), d // QBLOCK, 0),
            _lens(length, bh, q.device), out, d, 0, bh, 1, 1, s_len, d)
    return out


def q8_decode_attention_cache(q, kq, ks, vq, vs, lens,
                              layer: int) -> torch.Tensor:
    """q: (B, 1, H, D); kq/vq: (L, B, S, Hkv, D) int8; ks/vs:
    (L, B, S, Hkv, D // 32) f16; lens: (B,). Attends layer ``layer`` of
    the stacked cache. Returns (B, 1, H, D) in q's dtype."""
    if q.dim() != 4 or q.shape[1] != 1 or kq.dim() != 5 \
            or kq.shape[1] != q.shape[0] or q.shape[2] % kq.shape[3]:
        raise ValueError(f"q8_decode_attention: q {tuple(q.shape)} and "
                         f"stacked codes {tuple(kq.shape)} are not "
                         f"(B, 1, H, D), (L, B, S, Hkv, D)")
    if not 0 <= layer < kq.shape[0]:
        raise ValueError(f"q8_decode_attention: layer {layer} outside "
                         f"[0, {kq.shape[0]})")
    b, _, h, d = q.shape
    _check_planes(q, kq, ks, vq, vs, d)
    if not q.is_cuda:
        return plain.q8_decode_attention_cache(q, kq, ks, vq, vs, lens,
                                               layer)
    build.require_cuda("q8_decode_attention", q, kq, ks, vq, vs)
    if kq.stride() != vq.stride() or ks.stride() != vs.stride() \
            or kq.stride(4) != 1 or ks.stride(4) != 1:
        raise ValueError("q8_decode_attention: K and V planes must share "
                         "strides with contiguous rows")
    q = q.contiguous()
    out = torch.empty_like(q)
    k_l, v_l, ks_l, vs_l = kq[layer], vq[layer], ks[layer], vs[layer]
    _launch(q, h * d, d, k_l, v_l, k_l.stride()[:3], ks_l, vs_l,
            ks_l.stride()[:3], _lens(lens, b, q.device), out, h * d, d, b,
            h, kq.shape[3], kq.shape[2], d)
    return out


q8_decode_attention.launches = 0
