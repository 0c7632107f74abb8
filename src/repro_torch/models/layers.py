"""Shared model primitives of the port (the JAX package's
``models/layers.py``, Whisper paths).

Parameters are nested dicts of tensors; a stacked layer tree keeps its
leading layer axis and ``layer_slice`` takes one layer out of it. The
matrix products route through the kernel-dispatch API: ``mm`` / ``mm_out``
send 2-D weights to ``fp16_matmul`` and Q8_0 weights to ``q8_matmul``;
the 3-D per-head projections (QKV) stay ``torch.matmul``, as the
reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.api import dispatch
from repro_torch.quantize import QBLOCK, Q8Tensor, dequantize_q8_0


def ninit(gen: torch.Generator, shape, fan_in: int,
          device) -> torch.Tensor:
    """Scaled-normal init, N(0, 1) / sqrt(fan_in), float32."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * fan_in ** -0.5).to(device)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Q8Tensor):
        return Q8Tensor(tree.q[i], tree.scale[i])
    return tree[i]


def take_rows(leaf, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rows ``idx`` of a (rows, d) table, dequantized if it is a Q8Tensor
    blocked along the rows (equal to dequantizing the whole table, then
    gathering, since dequantization is per element)."""
    if isinstance(leaf, Q8Tensor):
        rows = leaf.q[idx].to(torch.float32) \
            * leaf.scale[torch.div(idx, QBLOCK, rounding_mode="floor")] \
            .to(torch.float32)
        return rows.to(dtype)
    return leaf[idx].to(dtype)


# ----------------------------------------------------------------------------
# Matrix products (C1: the serving path takes quantized weights)
# ----------------------------------------------------------------------------

def mm(x: torch.Tensor, w, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w, contracting x's last dim with w's first. ``w`` is a
    Q8Tensor (dispatched ``q8_matmul``), a 2-D tensor (dispatched
    ``fp16_matmul``) or a 3-D (k, heads, head_dim) tensor
    (``torch.matmul``)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if isinstance(w, Q8Tensor):
        w2 = Q8Tensor(w.q.reshape(k, -1),
                      w.scale.reshape(w.scale.shape[0], -1))
        y = dispatch("q8_matmul", x.reshape(-1, k).contiguous(), w2,
                     out_dtype=compute_dtype)
        return y.reshape(*lead, *w.q.shape[1:])
    w = w.to(compute_dtype)
    x = x.to(compute_dtype)
    if w.dim() == 2:
        return dispatch("fp16_matmul", x.contiguous(), w.contiguous(),
                        out_dtype=compute_dtype)
    if w.dim() == 3:   # (k, heads, head_dim)
        y = x.reshape(-1, k) @ w.reshape(k, -1)
        return y.reshape(*lead, *w.shape[1:])
    raise ValueError(f"unsupported weight rank {w.dim()}")


def mm_out(x: torch.Tensor, w, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., h, d) @ (h, d, n) -> (..., n) output projection."""
    if isinstance(w, Q8Tensor):
        h, d, n = w.q.shape
        w2 = Q8Tensor(w.q.reshape(h * d, n), w.scale.reshape(-1, n))
        y = dispatch("q8_matmul", x.reshape(-1, h * d).contiguous(), w2,
                     out_dtype=compute_dtype)
        return y.reshape(*x.shape[:-2], n)
    h, d, n = w.shape
    xc = x.to(compute_dtype).reshape(*x.shape[:-2], h * d).contiguous()
    return dispatch("fp16_matmul", xc,
                    w.to(compute_dtype).reshape(h * d, n).contiguous(),
                    out_dtype=compute_dtype)


# ----------------------------------------------------------------------------
# Norms, positions, embedding, head, MLP
# ----------------------------------------------------------------------------

def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32, with the population variance
    (``jnp.var``; ``torch.var`` defaults to the unbiased one)."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    """Whisper-encoder style sinusoids (S, D), float32."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


VOCAB_MULT = 2048


def pad_vocab(v: int, mult: int = VOCAB_MULT) -> int:
    return -(-v // mult) * mult


def embed(p: dict, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token rows of the (padded-vocab, d) table, in ``compute_dtype``."""
    return take_rows(p["table"], tokens, compute_dtype)


def logits_head(p: dict, x: torch.Tensor, vocab: int,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Tied head: f32 x @ table^T over the padded vocab; padding ids get
    a large negative logit."""
    tbl = p["table"]
    if isinstance(tbl, Q8Tensor):
        tbl = dequantize_q8_0(tbl, axis=-2)
    y = x.to(torch.float32) @ tbl.to(torch.float32).T
    if softcap is not None:
        y = softcap * torch.tanh(y / softcap)
    vp = y.shape[-1]
    pad_mask = torch.arange(vp, device=y.device) >= vocab
    return y - 1e9 * pad_mask.to(y.dtype)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain two-layer MLP (Whisper); a ``gate`` weight makes it gated."""
    up = mm(x, p["up"])
    if "gate" in p:
        h = _act(act)(mm(x, p["gate"])) * up
    else:
        h = _act(act)(up)
    return mm(h, p["down"])
