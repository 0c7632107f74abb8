"""Wrapper of the dense GEMM kernel (``csrc/fp16_matmul.cu``).

``fp16_matmul(x, w)`` computes ``x @ w`` with f32 accumulation for f32,
bf16 or f16 operands of one dtype. On CUDA tensors it launches the
kernel, which masks ragged M, N and K itself; on CPU tensors it runs the
plain version (``plain.py``). ``offload_info`` reports the paper's C2
split (a burst-aligned K main segment and a residual tail) that the
reference's TPU wrapper executes; the Hopper kernel takes the whole K,
so the split is analytic only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp16_matmul import plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: the reference's burst length of the C2 split (paper Sec III-B)
DEFAULT_BURST = 16


def _lib():
    lib = build.load("fp16_matmul")
    lib.fp16_matmul.argtypes = _ARGTYPES
    lib.fp16_matmul.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype) -> None:
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"fp16_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not (..., K) @ (K, N)")
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"fp16_matmul: operands must share one of f32, "
                        f"bf16, f16; got {x.dtype} and {w.dtype}")
    if out_dtype not in build.DTYPE_CODES:
        raise TypeError(f"fp16_matmul: unsupported out_dtype {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fp16_matmul: operands must be contiguous")


def fp16_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ w; x (..., K), w (K, N); returns (..., N) in
    ``out_dtype``."""
    _check(x, w, out_dtype)
    if not x.is_cuda:
        return plain.fp16_matmul(x, w, out_dtype)
    build.require_cuda("fp16_matmul", x, w)
    k, n = w.shape
    m = x.numel() // k if k else 0
    y = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _lib().fp16_matmul(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
        build.stream(x.device))
    build.check(rc, "fp16_matmul")
    fp16_matmul.launches += 1
    return y


fp16_matmul.launches = 0


def offload_info(m: int, n: int, k: int, burst: int = DEFAULT_BURST) -> dict:
    """The analytic C2 split of a GEMM's K into a burst-aligned main
    segment and a residual tail (``offload_fraction`` = k_main / k)."""
    k_main = (k // burst) * burst
    return dict(m=m, n=n, k=k, burst=burst, k_main=k_main,
                k_residual=k - k_main,
                offload_fraction=k_main / k if k else 0.0)
