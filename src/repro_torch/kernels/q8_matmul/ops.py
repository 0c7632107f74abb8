"""Wrapper of the Q8_0 GEMM kernel (``csrc/q8_matmul.cu``).

``q8_matmul(x, w)`` computes ``x @ dequant(w)`` for a ``Q8Tensor`` w of
shape (K, N) blocked along K. On CUDA tensors it launches the kernel,
which masks ragged M and N; on CPU tensors it runs the plain version
(``plain.py``).

The kernel has two layouts, picked by its C entry point from M: a
tensor-core tile above ``GEMV_MAX_M`` rows, and at or under it (decode,
the speculative verify) a GEMV. Either splits K across blocks where its
output tiles alone leave the card empty; the wrapper picks the split
count (``k_splits``) and allocates the workspace of the splits' partial
sums, which a second kernel adds in order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q8_matmul import plain
from repro_torch.quantize import QBLOCK, Q8Tensor

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

GEMV_MAX_M = 16       # the C entry point's threshold (csrc/q8_matmul.cu)
GEMV_BN = 128         # columns of a GEMV block
GEMV_MT = 4           # rows of x a GEMV block computes
GEMV_MAX_BLOCKS = 64  # 32-row scale blocks a split, at most
TILE_SB = 2           # scale blocks a stage of the narrow tile
TILE_RESIDENT = 3     # narrow tile blocks an SM holds
TILE_MIN_STAGES = 8   # stages a split where the tiles cover the SMs


def k_splits(m: int, n: int, k: int, sms: int, x_f32: bool = False) -> int:
    """Splits of K across blocks. The GEMV layout (M <= GEMV_MAX_M):
    enough whole scale blocks a split that the ceil(N/128) x ceil(M/4)
    column and row tiles times the splits reach the ``sms`` SMs, at most
    ``GEMV_MAX_BLOCKS`` blocks a split. The tile layout: none where its
    64x64 tiles number ``2 * sms`` or more (the kernel then takes its
    wide tile) or x is f32 (the f32 loop); else whole stages of
    ``TILE_SB`` scale blocks a split, as many splits as keep every block
    resident (``TILE_RESIDENT`` an SM), and where the tiles alone cover
    the SMs, at least ``TILE_MIN_STAGES`` stages a split, so that the
    split sum stays small beside the products."""
    blocks = k // QBLOCK
    if m > GEMV_MAX_M:
        tiles = build.cdiv(m, 64) * build.cdiv(n, 64)
        if x_f32 or tiles >= 2 * sms:
            return 1
        stages = build.cdiv(blocks, TILE_SB)
        least = TILE_MIN_STAGES if tiles >= sms else 1
        want = min(TILE_RESIDENT * sms // tiles, stages // least)
        if want <= 1:
            return 1
        return build.cdiv(stages, build.cdiv(stages, want))
    ctas = max(1, build.cdiv(n, GEMV_BN) * build.cdiv(m, GEMV_MT))
    per = max(1, blocks // build.cdiv(sms, ctas))
    return max(1, build.cdiv(blocks, min(per, GEMV_MAX_BLOCKS)))


_entry = []   # the C entry point, typed once


def _kernel():
    if not _entry:
        fn = build.load("q8_matmul").q8_matmul
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def _check(x: torch.Tensor, w: Q8Tensor, out_dtype) -> None:
    wq, ws = w.q, w.scale
    if wq.dim() != 2 or x.dim() < 1 or x.shape[-1] != wq.shape[0]:
        raise ValueError(f"q8_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(wq.shape)} is not (..., K) @ (K, N)")
    k, n = wq.shape
    if k % QBLOCK or tuple(ws.shape) != (k // QBLOCK, n):
        raise ValueError(f"q8_matmul: scales {tuple(ws.shape)} do not "
                         f"block codes {tuple(wq.shape)} by {QBLOCK} on K")
    if wq.dtype != torch.int8 or ws.dtype != torch.float16:
        raise TypeError(f"q8_matmul: codes must be int8 and scales f16, "
                        f"got {wq.dtype} and {ws.dtype}")
    if x.dtype not in build.DTYPE_CODES or out_dtype not in build.DTYPE_CODES:
        raise TypeError(f"q8_matmul: unsupported dtypes x {x.dtype}, "
                        f"out {out_dtype}")
    if not (x.is_contiguous() and wq.is_contiguous() and ws.is_contiguous()):
        raise ValueError("q8_matmul: operands must be contiguous")


def q8_matmul(x: torch.Tensor, w: Q8Tensor, *,
              out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w); x (..., K); returns (..., N) in
    ``out_dtype``."""
    _check(x, w, out_dtype)
    if not x.is_cuda:
        return plain.q8_matmul(x, w.q, w.scale, out_dtype)
    build.require_cuda("q8_matmul", x, w.q, w.scale)
    k, n = w.q.shape
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    splits = k_splits(m, n, k, build.sm_count(x.device),
                      x.dtype == torch.float32)
    work = None
    if splits > 1:
        work = torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device)
    rc = _kernel()(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), m, n, k, splits,
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
        build.stream(x.device))
    build.check(rc, "q8_matmul")
    q8_matmul.launches += 1
    return y


q8_matmul.launches = 0
