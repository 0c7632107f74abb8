"""Q8_0 and Q4_0 blockwise quantization (paper contribution C1), in
PyTorch.

The port's copy of the JAX package's ``core/quantize.py``: blocks of 32
elements along one axis, each stored as codes plus one f16 scale.

* Q8_0: 32 int8 codes, ``d = max(|x|) / 127``.
* Q4_0: codes in [-7, 7] with ``d = max(|x|) / 7``, biased by +8 and
  packed two per byte along the blocked axis (low nibble = even index),
  so the code plane is uint8 with that axis halved.

The code plane and the scale plane are two dense tensors, the layout the
Hopper kernels read. Codes and scales are bit-identical to the
reference: the arithmetic is the same f32 sequence, the f32 -> f16 cast
rounds to nearest even in both frameworks, and ``torch.round`` rounds
half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

QBLOCK = 32  # ggml Q8_0 block size (elements)
Q8_BYTES_PER_BLOCK = QBLOCK + 2  # 32 int8 + fp16 scale
Q8_BYTES_PER_ELEM = Q8_BYTES_PER_BLOCK / QBLOCK  # 1.0625
Q4_BYTES_PER_BLOCK = QBLOCK // 2 + 2  # 32 packed nibbles + fp16 scale
Q4_BYTES_PER_ELEM = Q4_BYTES_PER_BLOCK / QBLOCK  # 0.5625

#: Storage bytes per element of every storage tier the port knows.
BYTES_PER_ELEM = {
    "f32": 4.0,
    "f16": 2.0,
    "bf16": 2.0,
    "q8_0": Q8_BYTES_PER_ELEM,
    "q4_0": Q4_BYTES_PER_ELEM,
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


@dataclasses.dataclass
class Q4Tensor:
    """A Q4_0-quantized tensor. ``q``: uint8 with the blocked axis
    halved, two +8-biased 4-bit codes a byte (low nibble = even index).
    ``scale``: float16, the original shape with the blocked axis // 32."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        """Packed-plane shape (the blocked axis is halved)."""
        return self.q.shape

    @property
    def nbytes_packed(self) -> int:
        """Dense-packed storage bytes (optimized policy, C3)."""
        return self.q.numel() + 2 * self.scale.numel()


#: the quantized leaf types of a parameter tree
QTENSORS = (Q8Tensor, Q4Tensor)


def _check_last_dim(k: int) -> None:
    if k % QBLOCK != 0:
        raise ValueError(
            f"Q8_0/Q4_0 require the blocked dim ({k}) to be a multiple "
            f"of {QBLOCK}")


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


def pack_q4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte along ``axis`` (even
    length): byte i = (codes[2i] + 8) | ((codes[2i+1] + 8) << 4)."""
    axis = axis % codes.dim()
    cm = codes.movedim(axis, -1)
    k = cm.shape[-1]
    if k % 2 != 0:
        raise ValueError(f"pack_q4 needs an even axis length, got {k}")
    pairs = (cm.to(torch.int32) + 8).to(torch.uint8)
    pairs = pairs.reshape(*cm.shape[:-1], k // 2, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 4)
    return packed.movedim(-1, axis).contiguous()


def unpack_q4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_q4`: uint8 bytes -> int8 codes in [-8, 7],
    ``axis`` doubled."""
    axis = axis % packed.dim()
    pm = packed.movedim(axis, -1)
    lo = (pm & 0xF).to(torch.int8) - 8
    hi = (pm >> 4).to(torch.int8) - 8
    codes = torch.stack([lo, hi], dim=-1).reshape(*pm.shape[:-1],
                                                  2 * pm.shape[-1])
    return codes.movedim(-1, axis)


def quantize_q4_0(x: torch.Tensor, scale_dtype=torch.float16,
                  axis: int = -1) -> Q4Tensor:
    """Quantize to Q4_0 with 32-element blocks along ``axis``: codes in
    [-7, 7] with ``d = max(|x|) / 7``, packed two a byte along ``axis``."""
    axis = axis % x.dim()
    xm = x.movedim(axis, -1)
    _check_last_dim(xm.shape[-1])
    blocks = xm.to(torch.float32).reshape(*xm.shape[:-1], -1, QBLOCK)
    amax = blocks.abs().amax(dim=-1)
    d = (amax / 7.0).to(scale_dtype)
    df = d.to(torch.float32)
    inv = torch.where(df > 0, 1.0 / df, torch.zeros_like(df))
    q = torch.clamp(torch.round(blocks * inv[..., None]), -7, 7)
    codes = q.to(torch.int8).reshape(xm.shape).movedim(-1, axis)
    return Q4Tensor(q=pack_q4(codes, axis=axis),
                    scale=d.movedim(-1, axis).contiguous())


def dequantize_q4_0(t: Q4Tensor, dtype=torch.float32,
                    axis: int = -1) -> torch.Tensor:
    """Exact inverse of the storage transform (not of quantize: lossy)."""
    axis = axis % t.q.dim()
    qm = unpack_q4(t.q, axis=axis).movedim(axis, -1)
    sm = t.scale.movedim(axis, -1)
    q = qm.reshape(*qm.shape[:-1], -1, QBLOCK).to(torch.float32)
    x = q * sm.to(torch.float32)[..., None]
    return x.reshape(qm.shape).movedim(-1, axis).to(dtype)


def as_array(leaf: Any, dtype=torch.bfloat16, axis: int = -2) -> torch.Tensor:
    """Dequantize a Q8Tensor or Q4Tensor (blocked along ``axis``, the
    quantize_tree convention) or cast a plain tensor."""
    if isinstance(leaf, Q8Tensor):
        return dequantize_q8_0(leaf, dtype, axis=axis)
    if isinstance(leaf, Q4Tensor):
        return dequantize_q4_0(leaf, dtype, axis=axis)
    return leaf.to(dtype)


def quantize_tree(params: Any, predicate: Optional[Callable] = None,
                  tier: str = "q8_0") -> Any:
    """Quantize every float leaf of a nested-dict parameter tree that has
    at least two dims and a second-to-last dim divisible by 32 (weights
    are stored ``(..., K, N)`` and blocked along K) to a Q8Tensor
    (``tier="q8_0"``) or a Q4Tensor (``"q4_0"``, the speculative draft's
    weights); other leaves pass through. ``predicate(path, leaf)``
    narrows the selection."""
    if tier not in ("q8_0", "q4_0"):
        raise ValueError(
            f"unknown weight tier {tier!r}; supported: ['q4_0', 'q8_0']")
    qfn = quantize_q8_0 if tier == "q8_0" else quantize_q4_0

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
        return qfn(node, axis=-2)

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
