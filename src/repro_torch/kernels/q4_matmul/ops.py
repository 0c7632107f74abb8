"""Wrapper of the Q4_0 GEMM kernel (``csrc/q4_matmul.cu``).

``q4_matmul(x, w)`` computes ``x @ dequant(w)`` for a ``Q4Tensor`` w of
logical shape (K, N), nibble-packed along K: ``w.q`` is (K // 2, N)
uint8, ``w.scale`` (K // 32, N) f16. On CUDA tensors it launches the
kernel in the layout ``plan`` picks, which unpacks and scales the
nibbles in registers and masks ragged M and N (K is a multiple of 32; no
host-side C2 split); on CPU tensors it runs the plain version
(``plain.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.q4_matmul import plain
from repro_torch.quantize import QBLOCK, Q4Tensor

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

#: the kernel's layouts (the C entry point's ``layout`` argument)
ROWS, GEMV, MMA = 0, 1, 2
GEMV_MAX_M = 16       # rows at or under it: a GEMV
CGWS = (1, 2)         # column groups of 16 a warp the CUDA-core GEMV takes
MAX_WARPS = 8
CLUSTER_MAX = 8       # CTAs of a cluster splitting K (portable size)
MMA_CHUNKS = 3        # 16-k chunks a warp of the planned MMA GEMV takes


def rows_per_rank(k: int, ranks: int) -> int:
    """Packed rows of w a rank of the cluster takes: whole runs of 8."""
    return 8 * build.cdiv(build.cdiv(k // 2, ranks), 8)


def gemv_fits(k: int, cgw: int, warps: int, ranks: int) -> bool:
    """The C entry point takes this GEMV: a known column-group width (0
    for the tensor-core GEMV), 1-8 warps, and 1-8 ranks none of which is
    left without rows of w."""
    return ((cgw in CGWS or cgw == 0) and 1 <= warps <= MAX_WARPS
            and 1 <= ranks <= CLUSTER_MAX
            and build.cdiv(k // 2, rows_per_rank(k, ranks)) == ranks)


def plan(m: int, n: int, k: int, sms: int, x_dtype=torch.bfloat16,
         aligned: bool = True) -> tuple[int, int, int, int]:
    """The kernel's layout for an (m, k) @ (k, n) product: (layout, cgw,
    warps, ranks) as the C entry point takes them. ``aligned``: x starts
    on 4 bytes (its rows then do: K is a multiple of 32).

    * 2 <= M <= GEMV_MAX_M, bf16 or f16 x, aligned: the tensor-core GEMV,
      16 columns and 8 warps a CTA, and CTAs a cluster splitting K: the
      power of two (up to CLUSTER_MAX, each rank a whole number of 8-row
      runs of the packed w; the most under it that fits, where it does
      not) that leaves a warp at most MMA_CHUNKS 16-k chunks.
    * Else at M <= GEMV_MAX_M (one row, f32 x, unaligned rows): the
      CUDA-core GEMV, one column group of 16 a warp, 8 warps a CTA, K
      split alike so that a lane takes at most one packed row.
      Measured on an H100 (``probe.py``, PERF.md): the tensor cores win
      from 2 rows on, the CUDA cores at one row (whose products are few);
      narrow column tiles and full CTAs win at the draft's shapes, and a
      cluster pays only where K is long (``sms`` does not change the
      choice there).
    * Else: the row tile (32 columns and 4 rows of x a block, all K).
    """
    if m > GEMV_MAX_M:
        return ROWS, 0, 0, 0
    warps = MAX_WARPS
    if m >= 2 and x_dtype in (torch.bfloat16, torch.float16) and aligned:
        layout, cgw = MMA, 0
        want = build.cdiv(k // 16, MMA_CHUNKS * warps)
    else:
        layout, cgw = GEMV, 1
        want = build.cdiv(k // 2, warps * 32)
    ranks = 1
    while ranks < min(want, CLUSTER_MAX):
        ranks *= 2
    while not gemv_fits(k, cgw, warps, ranks):
        ranks -= 1
    return layout, cgw, warps, ranks


_entry = []   # the C entry point, typed once


def _kernel():
    if not _entry:
        fn = build.load("q4_matmul").q4_matmul
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


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
    layout, cgw, warps, ranks = plan(m, n, k, build.sm_count(x.device),
                                     x.dtype, x.data_ptr() % 4 == 0)
    rc = _kernel()(
        x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), y.data_ptr(),
        m, n, k, build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
        layout, cgw, warps, ranks, build.stream(x.device))
    build.check(rc, "q4_matmul")
    q4_matmul.launches += 1
    return y


q4_matmul.launches = 0
