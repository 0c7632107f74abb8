"""Wrapper of the dense GEMM kernel (``csrc/fp16_matmul.cu``).

``fp16_matmul(x, w)`` computes ``x @ w`` with f32 accumulation for f32,
bf16 or f16 operands of one dtype, or an f32 ``x`` with a bf16 or f16
``w``, which the kernel widens as it reads it (the xLSTM head's f32
activations against its bf16 ``lm_head``). On CUDA tensors it launches
the kernel in the layout ``plan`` picks; on CPU tensors it runs the
plain version (``plain.py``). ``offload_info`` reports the paper's C2
split (a burst-aligned K main segment and a residual tail) that the
reference's TPU wrapper executes; the Hopper kernel takes the whole K,
so the split is analytic only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.burst import DEFAULT_BURST, split_burst
from repro_torch.kernels import build
from repro_torch.kernels.fp16_matmul import plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

#: the kernel's layouts (the C entry point's ``layout`` argument)
FMA, TILE, GEMV = 0, 1, 2
GEMV_MAX_M = 16       # rows at or under it: the GEMV
TILE_WIDE, TILE_MID, TILE_NARROW = 0, 1, 2   # 128x128, 64x128, 64x64
CLUSTER_MAX = 8       # CTAs of a cluster splitting K (portable size)
GEMV_COLS = 128       # columns of a GEMV CTA
GEMV_WARPS = 4
GEMV_SMEM = 200 * 1024   # bytes of x a GEMV CTA stages, at most

#: (x dtype, w dtype) pairs the kernel takes
PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
         (torch.float32, torch.float16)}


def _pow2_at_least(m: int) -> int:
    p = 1
    while p < m:
        p *= 2
    return p


def _gemv_smem(k: int, ranks: int, mt: int) -> int:
    """Bytes of shared memory a GEMV CTA takes: its rows of x as f32 and
    the slots of the partial sums it adds (csrc/fp16_matmul.cu)."""
    per = build.cdiv(mt * GEMV_COLS, ranks)
    return 4 * (max(build.cdiv(k, ranks) * mt, GEMV_WARPS * mt * GEMV_COLS)
                + ranks * per)


def plan(m: int, n: int, k: int, x_dtype, w_dtype, sms: int,
         aligned: bool = True) -> tuple[int, int, int]:
    """The kernel's layout for an (m, k) @ (k, n) product: (layout, p0,
    p1) as the C entry point takes them. ``aligned``: x, w and y start on
    16 bytes (their rows then do where K and N are multiples of 8).

    * f32 x and f32 w (only the frontend makes them): the FMA loop at
      every M. Each output there is one ``fmaf`` chain over k in order,
      so a row's bits do not depend on M, which the streaming frontend
      needs: its pushes make these products over a few rows, the
      one-shot frontend over thousands. The GEMV's cross-CTA sum would
      give a row of a small call other bits.
    * M <= GEMV_MAX_M: the GEMV for every other operand pair (w in bf16
      or f16), with p0 column groups of 16 bytes a warp (GEMV_COLS
      columns a CTA: 16 groups of 8) and p1 CTAs a cluster splitting K: as
      many, up to CLUSTER_MAX, as make the column tiles twice the
      ``sms`` SMs, and enough that each CTA's rows of x and partial
      sums fit GEMV_SMEM.
      Measured on an H100 (``probe.py``, PERF.md): a full cluster of 8
      beats more, narrower column tiles at the decoder's shapes.
    * bf16 or f16 x and w, K and N multiples of 8 and at least 64,
      aligned: the wgmma tile, 128x128 where those tiles number at least
      one an SM, 64x128 where those number half the SMs, else 64x64.
    * Else (f32 x, or rows that are not 16-byte aligned): the FMA loop.
    """
    if x_dtype == torch.float32 and w_dtype == torch.float32:
        return FMA, 0, 0
    if m <= GEMV_MAX_M:
        cgw = GEMV_COLS // 8
        tiles = build.cdiv(n, GEMV_COLS)
        ranks = min(CLUSTER_MAX, build.cdiv(2 * sms, tiles))
        mt = _pow2_at_least(m)
        while _gemv_smem(k, ranks, mt) > GEMV_SMEM:
            if ranks == CLUSTER_MAX:
                raise ValueError(f"fp16_matmul: K={k} at M={m} exceeds "
                                 f"the GEMV's staging of x")
            ranks += 1
        return GEMV, cgw, ranks
    if x_dtype == w_dtype and x_dtype != torch.float32 and aligned \
            and k % 8 == 0 and n % 8 == 0 and k >= 64 and n >= 64:
        if build.cdiv(m, 128) * build.cdiv(n, 128) >= sms:
            return TILE, TILE_WIDE, 0
        if 2 * build.cdiv(m, 64) * build.cdiv(n, 128) >= sms:
            return TILE, TILE_MID, 0
        return TILE, TILE_NARROW, 0
    return FMA, 0, 0


_entry = []   # the C entry point, typed once


def _kernel():
    if not _entry:
        fn = build.load("fp16_matmul").fp16_matmul
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype) -> None:
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"fp16_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not (..., K) @ (K, N)")
    if (x.dtype, w.dtype) not in PAIRS:
        raise TypeError(f"fp16_matmul: operands must share one of f32, "
                        f"bf16, f16, or be f32 x with bf16 or f16 w; got "
                        f"{x.dtype} and {w.dtype}")
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
    if k == 0:
        return y.zero_()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0
    layout, p0, p1 = plan(m, n, k, x.dtype, w.dtype,
                          build.sm_count(x.device), aligned)
    rc = _kernel()(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[w.dtype],
        build.DTYPE_CODES[out_dtype], layout, p0, p1,
        build.stream(x.device))
    build.check(rc, "fp16_matmul")
    fp16_matmul.launches += 1
    return y


fp16_matmul.launches = 0


def offload_info(m: int, n: int, k: int, burst: int = DEFAULT_BURST) -> dict:
    """The analytic C2 split of a GEMM's K into a burst-aligned main
    segment and a residual tail (``core.burst.split_burst``)."""
    s = split_burst(k, burst)
    return dict(m=m, n=n, k=k, burst=burst, k_main=s.k_main,
                k_residual=s.k_residual,
                offload_fraction=s.offload_fraction)
