"""Plain PyTorch version of the dense GEMM: the HOST backend and the
oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch


def fp16_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """y = f32(x) @ f32(w), accumulated in f32, cast to ``out_dtype``."""
    return (x.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)
