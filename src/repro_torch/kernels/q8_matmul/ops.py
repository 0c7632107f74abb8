"""Wrapper of the Q8_0 GEMM kernel (``csrc/q8_matmul.cu``).

``q8_matmul(x, w)`` computes ``x @ dequant(w)`` for a ``Q8Tensor`` w of
shape (K, N) blocked along K. On CUDA tensors it launches the kernel,
which dequantizes the weight tile in shared memory and masks ragged M, N
and K; on CPU tensors it runs the plain version (``plain.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q8_matmul import plain
from repro_torch.quantize import QBLOCK, Q8Tensor

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = build.load("q8_matmul")
    lib.q8_matmul.argtypes = _ARGTYPES
    lib.q8_matmul.restype = ctypes.c_int
    return lib


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
    rc = _lib().q8_matmul(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), y.data_ptr(),
        m, n, k, build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
        build.stream(x.device))
    build.check(rc, "q8_matmul")
    q8_matmul.launches += 1
    return y


q8_matmul.launches = 0
