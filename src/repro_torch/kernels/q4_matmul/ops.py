"""Wrapper of the Q4_0 GEMM kernel (``csrc/q4_matmul.cu``).

``q4_matmul(x, w)`` computes ``x @ dequant(w)`` for a ``Q4Tensor`` w of
logical shape (K, N), nibble-packed along K: ``w.q`` is (K // 2, N)
uint8, ``w.scale`` (K // 32, N) f16. On CUDA tensors it launches the
kernel, which unpacks and scales the nibbles in registers and masks
ragged M and N (K is a multiple of 32; no host-side C2 split); on CPU
tensors it runs the plain version (``plain.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q4_matmul import plain
from repro_torch.quantize import QBLOCK, Q4Tensor

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = build.load("q4_matmul")
    lib.q4_matmul.argtypes = _ARGTYPES
    lib.q4_matmul.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: Q4Tensor, out_dtype) -> None:
    wp, ws = w.q, w.scale
    if wp.dim() != 2 or x.dim() < 1 or x.shape[-1] != 2 * wp.shape[0]:
        raise ValueError(f"q4_matmul: x {tuple(x.shape)} @ packed w "
                         f"{tuple(wp.shape)} is not (..., K) @ (K/2, N)")
    k, n = 2 * wp.shape[0], wp.shape[1]
    if k % QBLOCK or tuple(ws.shape) != (k // QBLOCK, n):
        raise ValueError(f"q4_matmul: scales {tuple(ws.shape)} do not "
                         f"block K={k} by {QBLOCK} for N={n}")
    if wp.dtype != torch.uint8 or ws.dtype != torch.float16:
        raise TypeError(f"q4_matmul: codes must be uint8 and scales f16, "
                        f"got {wp.dtype} and {ws.dtype}")
    if x.dtype not in build.DTYPE_CODES or out_dtype not in build.DTYPE_CODES:
        raise TypeError(f"q4_matmul: unsupported dtypes x {x.dtype}, "
                        f"out {out_dtype}")
    if not (x.is_contiguous() and wp.is_contiguous() and ws.is_contiguous()):
        raise ValueError("q4_matmul: operands must be contiguous")


def q4_matmul(x: torch.Tensor, w: Q4Tensor, *,
              out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w); x (..., K); returns (..., N) in
    ``out_dtype``."""
    _check(x, w, out_dtype)
    if not x.is_cuda:
        return plain.q4_matmul(x, w.q, w.scale, out_dtype)
    build.require_cuda("q4_matmul", x, w.q, w.scale)
    k, n = 2 * w.q.shape[0], w.q.shape[1]
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _lib().q4_matmul(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), y.data_ptr(),
        m, n, k, build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
        build.stream(x.device))
    build.check(rc, "q4_matmul")
    q4_matmul.launches += 1
    return y


q4_matmul.launches = 0
