"""Plain PyTorch version of the Q4_0 GEMM: the HOST backend and the
oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

from repro_torch.quantize import QBLOCK, unpack_q4


def dequant(wp: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """wp: (K // 2, N) packed uint8, ws: (K // 32, N) -> (K, N) f32."""
    codes = unpack_q4(wp, axis=0).to(torch.float32)
    return codes * ws.to(torch.float32).repeat_interleave(QBLOCK, dim=0)


def q4_matmul(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """y = f32(x) @ dequant(wp, ws), accumulated in f32."""
    return (x.to(torch.float32) @ dequant(wp, ws)).to(out_dtype)
