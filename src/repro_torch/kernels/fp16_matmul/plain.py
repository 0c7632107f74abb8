"""Plain PyTorch version of the dense GEMM: the HOST backend and the
oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch


def fp16_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """y = f32(x) @ f32(w), accumulated in f32, cast to ``out_dtype``.
    The f32 x f32 pair (the frontend's) sums each output in k order
    (``_rowwise_f32``), so an output row's bits do not depend on how many
    rows the call has."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return _rowwise_f32(x, w).to(out_dtype)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def _rowwise_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) in f32, one rounded multiply and one rounded
    add a term, over k in order: each element is computed alone, so a
    row comes out with the same bits whatever rows share the call. A
    library GEMM blocks the rows by M and does not: the streaming
    frontend makes these products over a push's few rows and must equal
    the one-shot frontend's thousands bit for bit."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    y = torch.zeros((x2.shape[0], w.shape[1]), dtype=torch.float32,
                    device=x.device)
    for i in range(k):
        y += x2[:, i:i + 1] * w[i]
    return y.reshape(*lead, w.shape[1])
