"""Q8_0 blockwise quantization (paper contribution C1), in PyTorch.

The port's copy of the JAX package's ``core/quantize.py`` for the Q8_0
tier: blocks of 32 elements along one axis, each stored as 32 int8
codes plus one f16 scale ``d = max(|x|) / 127``. The code plane and the
scale plane are two dense tensors, the layout the Hopper kernels read.

Codes and scales are bit-identical to the reference: the arithmetic is
the same f32 sequence, the f32 -> f16 cast rounds to nearest even in
both frameworks, and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

QBLOCK = 32  # ggml Q8_0 block size (elements)
Q8_BYTES_PER_BLOCK = QBLOCK + 2  # 32 int8 + fp16 scale
Q8_BYTES_PER_ELEM = Q8_BYTES_PER_BLOCK / QBLOCK  # 1.0625

#: Storage bytes per element of every storage tier the port knows.
BYTES_PER_ELEM = {
    "f32": 4.0,
    "f16": 2.0,
    "bf16": 2.0,
    "q8_0": Q8_BYTES_PER_ELEM,
}

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def bytes_per_elem(dtype: str) -> float:
    """Element size of a storage tier; ``ValueError`` on an unknown one."""
    try:
        return BYTES_PER_ELEM[dtype]
    except KeyError:
        raise ValueError(
            f"unknown storage dtype {dtype!r}; supported tiers: "
            f"{sorted(BYTES_PER_ELEM)}") from None


@dataclasses.dataclass
class Q8Tensor:
    """A Q8_0-quantized tensor. ``q``: int8 of the original shape.
    ``scale``: float16, the original shape with the blocked axis // 32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes_packed(self) -> int:
        """Dense-packed storage bytes (optimized policy, C3)."""
        return self.q.numel() + 2 * self.scale.numel()


def _check_last_dim(k: int) -> None:
    if k % QBLOCK != 0:
        raise ValueError(
            f"Q8_0 requires the blocked dim ({k}) to be a multiple of "
            f"{QBLOCK}")


def quantize_q8_0(x: torch.Tensor, scale_dtype=torch.float16,
                  axis: int = -1) -> Q8Tensor:
    """Quantize to Q8_0 with 32-element blocks along ``axis``."""
    axis = axis % x.dim()
    xm = x.movedim(axis, -1)
    _check_last_dim(xm.shape[-1])
    blocks = xm.to(torch.float32).reshape(*xm.shape[:-1], -1, QBLOCK)
    amax = blocks.abs().amax(dim=-1)
    d = (amax / 127.0).to(scale_dtype)
    df = d.to(torch.float32)
    # ggml: inverse scale with a zero guard
    inv = torch.where(df > 0, 1.0 / df, torch.zeros_like(df))
    q = torch.clamp(torch.round(blocks * inv[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(xm.shape).movedim(-1, axis)
    return Q8Tensor(q=q.contiguous(), scale=d.movedim(-1, axis).contiguous())


def dequantize_q8_0(t: Q8Tensor, dtype=torch.float32,
                    axis: int = -1) -> torch.Tensor:
    """Exact inverse of the storage transform (not of quantize: lossy)."""
    axis = axis % t.q.dim()
    qm = t.q.movedim(axis, -1)
    sm = t.scale.movedim(axis, -1)
    q = qm.reshape(*qm.shape[:-1], -1, QBLOCK).to(torch.float32)
    x = q * sm.to(torch.float32)[..., None]
    return x.reshape(qm.shape).movedim(-1, axis).to(dtype)


def as_array(leaf: Any, dtype=torch.bfloat16, axis: int = -2) -> torch.Tensor:
    """Dequantize a Q8Tensor (blocked along ``axis``, the quantize_tree
    convention) or cast a plain tensor."""
    if isinstance(leaf, Q8Tensor):
        return dequantize_q8_0(leaf, dtype, axis=axis)
    return leaf.to(dtype)


def quantize_tree(params: Any, predicate: Optional[Callable] = None,
                  tier: str = "q8_0") -> Any:
    """Quantize every float leaf of a nested-dict parameter tree that has
    at least two dims and a second-to-last dim divisible by 32 (weights
    are stored ``(..., K, N)`` and blocked along K); other leaves pass
    through. ``predicate(path, leaf)`` narrows the selection. Only the
    ``q8_0`` tier is ported so far (q4_0 is ROADMAP queue 1, item 11)."""
    if tier != "q8_0":
        raise NotImplementedError(
            f"weight tier {tier!r} is not ported yet (ROADMAP queue 1, "
            f"item 11: q4_0 tier); supported: ['q8_0']")

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        if node.dim() < 2 or node.dtype not in _FLOAT_DTYPES:
            return node
        if node.shape[-2] % QBLOCK != 0:
            return node
        if predicate is not None and not predicate(path, node):
            return node
        return quantize_q8_0(node, axis=-2)

    return walk((), params)


def stored_bytes(shape, dtype: str, policy: str = "optimized",
                 align_bytes: int = 32) -> int:
    """Bytes of a tensor under a packing policy (``baseline`` pads each
    row to ``align_bytes``; ``optimized`` is the paper's dense packing)."""
    elem = bytes_per_elem(dtype)
    *lead, k = shape
    rows = 1
    for d in lead:
        rows *= d
    row_bytes = k * elem
    if policy == "baseline":
        row_bytes = -(-row_bytes // align_bytes) * align_bytes
    return int(rows * row_bytes)
