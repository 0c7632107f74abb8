"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` over the model's (B, S, H, D) layout with
GQA (H % Hkv == 0). Sq and Skv may differ (cross-attention prefill).
The kernel takes bf16 with head_dim 64 (whisper-tiny.en) or 32 (its
reduced configuration); calls outside that raise on every device. On
CUDA tensors it launches the kernel, which reads KV heads by index and
masks a ragged S itself; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import plain

HEAD_DIMS = (32, 64)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = _ARGTYPES
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, Sq, H, D), (B, Skv, Hkv, D)")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and kv "
                         f"{tuple(k.shape)} disagree on B, D or GQA")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_attention: q, k, v must be bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D). Returns (B, Sq, H, D)
    in q's dtype."""
    _check(q, k, v, window)
    if not q.is_cuda:
        return plain.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    build.require_cuda("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        skv, h, hkv, d, int(causal), int(window or 0),
        float(softcap or 0.0), build.stream(q.device))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
