"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` over the model's (B, S, H, D) layout with
GQA (H % Hkv == 0). Sq and Skv may differ (cross-attention prefill),
and ``q_offset`` places query row i at position q_offset + i (key j at
j): a context-parallel prefill's rank attends its block of the
positions over the whole K and V.
The kernel takes bf16 with head_dim 64 (whisper-tiny.en, whisper-base),
32 (the reduced configurations), 112 (zamba2-7b's shared attention), 128
(the other decoder-only models) or 256 (gemma2-2b); calls outside that
raise on every device. On CUDA tensors
it launches the kernel, which reads KV heads by index and masks a ragged
S itself; on CPU tensors it runs the plain version.

Where the kernel's query tiles leave the card empty (the cross-attention
prefill: 32 queries against 1500 frames; the encoder's 72 tiles), the
wrapper splits each tile's KV range across blocks (``kv_splits``) and
hands the kernel a workspace for the splits' partial softmax states,
which a second kernel combines in order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import plain

#: head_dim -> (queries a block, keys a KV tile, blocks an SM holds):
#: the kernel's Layout<D> (csrc/flash_attention.cu)
LAYOUT = {32: (128, 64, 2), 64: (128, 64, 2), 112: (64, 64, 2),
          128: (64, 64, 2), 256: (64, 32, 1)}
HEAD_DIMS = tuple(LAYOUT)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def kv_splits(b: int, sq: int, skv: int, h: int, sms: int,
              d: int) -> int:
    """How many blocks share one query tile's KV range: as many splits
    of whole KV tiles as the ``sms`` SMs hold blocks beside the query
    tiles (B*H*ceil(Sq/BQ)), at the head_dim's resident blocks an SM
    (``LAYOUT``); 1 where the query tiles alone fill that."""
    bq, bkv, resident = LAYOUT[d]
    ctas = build.cdiv(sq, bq) * b * h
    tiles = build.cdiv(skv, bkv)
    want = resident * sms // ctas
    if want <= 1 or tiles <= 1:
        return 1
    per = build.cdiv(tiles, want)   # tiles a split
    return build.cdiv(tiles, per)


_entry = []   # the C entry point, typed once


def _kernel():
    if not _entry:
        fn = build.load("flash_attention").flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def _check(q, k, v, window, q_offset) -> None:
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
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); query row i at
    position q_offset + i. Returns (B, Sq, H, D) in q's dtype."""
    _check(q, k, v, window, q_offset)
    if not q.is_cuda:
        return plain.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset)
    build.require_cuda("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits = kv_splits(b, sq, skv, h, build.sm_count(q.device), d)
    part_o = part_ml = None
    if splits > 1:   # each split's acc (D floats a row), then its (m, l)
        rows = splits * b * h * sq
        work = torch.empty(rows * (d + 2), dtype=torch.float32,
                           device=q.device)
        part_o = work.data_ptr()
        part_ml = part_o + rows * d * 4
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_o,
        part_ml, b, sq, skv, h, hkv, d, int(causal), int(window or 0),
        int(q_offset), float(softcap or 0.0), splits,
        build.stream(q.device))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
