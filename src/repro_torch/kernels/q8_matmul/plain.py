"""Plain PyTorch version of the Q8_0 GEMM: the HOST backend and the
oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

from repro_torch.quantize import QBLOCK


def dequant(wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """wq: (K, N) int8, ws: (K // 32, N) -> (K, N) f32."""
    return wq.to(torch.float32) * ws.to(torch.float32).repeat_interleave(
        QBLOCK, dim=0)


def q8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """y = f32(x) @ dequant(wq, ws), accumulated in f32."""
    return (x.to(torch.float32) @ dequant(wq, ws)).to(out_dtype)
