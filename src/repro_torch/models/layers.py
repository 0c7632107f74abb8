"""Shared model primitives of the port (the JAX package's
``models/layers.py``, the Whisper, xLSTM and decoder-only paths).

Parameters are nested dicts of tensors; a stacked layer tree keeps its
leading layer axis and ``layer_slice`` takes one layer out of it. The
matrix products route through the kernel-dispatch API: ``mm`` / ``mm_out``
send 2-D weights to ``fp16_matmul``, Q8_0 weights to ``q8_matmul`` and
Q4_0 weights (the speculative draft's) to ``q4_matmul``; the 3-D per-head
projections (QKV) stay ``torch.matmul``, as the reference leaves them to
XLA. A Q4_0 vocab table is widened to bf16 for the embedding and the
tied head, as the reference does outside any kernel; the tied head then
multiplies in f32 with f32 accumulation, the reference's bf16 x bf16 ->
f32 product. An untied head (``lm_head``) is ``mm`` in f32: it
runs on ``fp16_matmul`` with f32 activations and the bf16 weight as it
is stored, widened in the kernel, the reference's f32 x f32 product
without an f32 copy of the weight.

A serving tree (``Model.prepare_serving``) carries tensors that a
forward would otherwise derive from the weights at every call, such as
the tied head's f32 operand (``prepare_head``); ``prepared`` reads one
where it is present and makes it as before where it is not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.api import current_context, dispatch, use_context
from repro_torch.quantize import (QBLOCK, QTENSORS, Q4Tensor, Q8Tensor,
                                  dequantize_q8_0, unpack_q4)


_BF16 = torch.bfloat16
_F32 = torch.float32


def prepared(p: dict, key: str, make) -> torch.Tensor:
    """``p[key]`` where ``prepare_serving`` stored it, else ``make()``:
    the same tensor either way, made once or at this call."""
    t = p.get(key)
    return make() if t is None else t


#: the projection weights of an attention, MLP or MoE dict, which ``mm``,
#: ``mm_out`` and the experts' products multiply in bf16
_PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")


def bf16_proj(tree: dict) -> dict:
    """``tree`` with every float projection weight in bf16, the dtype it
    is multiplied in; quantized weights and norms as they are."""
    return {k: bf16_proj(v) if isinstance(v, dict)
            else v.to(torch.bfloat16)
            if k in _PROJ and isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def ninit(gen: torch.Generator, shape, fan_in: int, device,
          dtype=torch.float32) -> torch.Tensor:
    """Scaled-normal init, N(0, 1) / sqrt(fan_in), drawn in float32 on
    the generator's device and stored in ``dtype`` on ``device`` (a
    CUDA generator and bf16 keep the f32 peak at one leaf)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * fan_in ** -0.5).to(device=device, dtype=dtype)


def remat_on(cfg, mode: str) -> bool:
    """Whether a stack recomputes its layers' activations in the
    backward: ``cfg.remat`` in a train forward under autograd, never in
    prefill or decode."""
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def remat(fn, *args):
    """``fn(*args)``, its activations dropped and recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint`` with ``nothing_saveable``). The recomputation runs
    under this call's dispatch context, so it binds what the forward
    bound (the grad-safe route in training)."""
    ctx = current_context()

    def again(*a):
        with use_context(ctx):
            return fn(*a)
    return checkpoint(again, *args, use_reentrant=False)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QTENSORS):
        return type(tree)(tree.q[i], tree.scale[i])
    return tree[i]


def stack_layers(trees: list):
    """Stack per-layer parameter (or cache) trees on a new leading axis:
    the inverse of ``layer_slice``."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _q4_row_codes(leaf: Q4Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Int8 codes of rows ``idx`` of a Q4 table packed along the rows:
    row r sits in byte row r // 2, low nibble for even r."""
    packed = leaf.q[torch.div(idx, 2, rounding_mode="floor")]
    odd = (idx % 2 == 1)[..., None]
    return torch.where(odd, packed >> 4, packed & 0xF).to(torch.int8) - 8


def _row_scales(leaf, idx: torch.Tensor) -> torch.Tensor:
    return leaf.scale[torch.div(idx, QBLOCK, rounding_mode="floor")]


def take_rows(leaf, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rows ``idx`` of a (rows, d) table, dequantized in f32 if it is a
    Q8Tensor or Q4Tensor blocked along the rows (equal to dequantizing the
    whole table, then gathering, since dequantization is per element)."""
    if isinstance(leaf, Q8Tensor):
        codes = leaf.q[idx]
    elif isinstance(leaf, Q4Tensor):
        codes = _q4_row_codes(leaf, idx)
    else:
        return leaf[idx].to(dtype)
    rows = codes.to(torch.float32) * _row_scales(leaf, idx).to(torch.float32)
    return rows.to(dtype)


def _q4_rows_bf16(leaf: Q4Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a Q4 table widened as the reference's
    ``_dequant_q4_bf16``: bf16 codes times bf16 scales, in bf16."""
    return _q4_row_codes(leaf, idx).to(torch.bfloat16) \
        * _row_scales(leaf, idx).to(torch.bfloat16)


def _dequant_q4_bf16(t: Q4Tensor) -> torch.Tensor:
    """A vocab-axis-packed Q4 table dequantized to bf16 (no f32 plane)."""
    codes = unpack_q4(t.q, axis=-2).to(torch.bfloat16)
    return codes * t.scale.to(torch.bfloat16).repeat_interleave(QBLOCK,
                                                                dim=-2)


# ----------------------------------------------------------------------------
# Matrix products (C1: the serving path takes quantized weights)
# ----------------------------------------------------------------------------

def mm(x: torch.Tensor, w, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w, contracting x's last dim with w's first. ``w`` is a
    Q8Tensor or Q4Tensor (dispatched ``q8_matmul`` / ``q4_matmul``), a
    2-D tensor (dispatched ``fp16_matmul``) or a 3-D (k, heads,
    head_dim) tensor (``torch.matmul``)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if isinstance(w, QTENSORS):
        # a Q4 plane is packed along K: (K // 2, ...) for a logical
        # (K, ...) weight, so the output dims are w.q.shape[1:] either way
        op = "q8_matmul" if isinstance(w, Q8Tensor) else "q4_matmul"
        w2 = type(w)(w.q.reshape(w.q.shape[0], -1),
                     w.scale.reshape(w.scale.shape[0], -1))
        y = dispatch(op, x.reshape(-1, k).contiguous(), w2,
                     out_dtype=compute_dtype)
        return y.reshape(*lead, *w.q.shape[1:])
    x = x.to(compute_dtype)
    if w.dim() == 2:
        # an f32 product takes a bf16 or f16 weight as it is stored and
        # widens it in the kernel (the untied head): the same f32
        # products, without an f32 copy of the weight each call
        if not (compute_dtype == torch.float32
                and w.dtype in (torch.bfloat16, torch.float16)):
            w = w.to(compute_dtype)
        return dispatch("fp16_matmul", x.contiguous(), w.contiguous(),
                        out_dtype=compute_dtype)
    w = w.to(compute_dtype)
    if w.dim() == 3:   # (k, heads, head_dim)
        y = x.reshape(-1, k) @ w.reshape(k, -1)
        return y.reshape(*lead, *w.shape[1:])
    raise ValueError(f"unsupported weight rank {w.dim()}")


def mm_out(x: torch.Tensor, w, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., h, d) @ (h, d, n) -> (..., n) output projection. A Q4Tensor
    is packed along head_dim: (h, d // 2, n), and d % 32 == 0 keeps the
    flattened (h * d) contraction's 32-blocks inside one head."""
    if isinstance(w, QTENSORS):
        op = "q8_matmul" if isinstance(w, Q8Tensor) else "q4_matmul"
        h, dq, n = w.q.shape
        w2 = type(w)(w.q.reshape(h * dq, n), w.scale.reshape(-1, n))
        y = dispatch(op, x.reshape(-1, x.shape[-2] * x.shape[-1])
                     .contiguous(), w2, out_dtype=compute_dtype)
        return y.reshape(*x.shape[:-2], n)
    h, d, n = w.shape
    xc = x.to(compute_dtype).reshape(*x.shape[:-2], h * d).contiguous()
    return dispatch("fp16_matmul", xc,
                    w.to(compute_dtype).reshape(h * d, n).contiguous(),
                    out_dtype=compute_dtype)


# ----------------------------------------------------------------------------
# Norms, positions, embedding, head, MLP
# ----------------------------------------------------------------------------

def init_rmsnorm(d: int, device) -> torch.Tensor:
    return torch.ones(d, device=device)


def rmsnorm(w: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.to(torch.float32)).to(dt)


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


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary positions (the reference's ``layers.rope``): x (B, S, H, D),
    positions (B, S). The angles are f32, and a bf16 x meets the f32
    cos / sin as jax promotes it: rotated in f32, then cast back."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


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


def init_embedding(gen: torch.Generator, vocab: int, d: int, device,
                   dtype=torch.float32) -> dict:
    """The (padded-vocab, d) token table, scaled normal."""
    return {"table": ninit(gen, (pad_vocab(vocab), d), d, device, dtype)}


def embed(p: dict, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token rows of the (padded-vocab, d) table, in ``compute_dtype``. A
    Q4 table is widened to bf16, as the reference's ``embed`` does."""
    tbl = p["table"]
    if isinstance(tbl, Q4Tensor):
        return _q4_rows_bf16(tbl, tokens).to(compute_dtype)
    return take_rows(tbl, tokens, compute_dtype)


def tied_head_f32(tbl) -> torch.Tensor:
    """The (padded vocab, d) f32 operand of the tied head: a float table
    widened (the table itself when it is f32), a Q8 table dequantized in
    f32, a Q4 table (the draft's) dequantized to bf16 as the reference's
    ``_dequant_q4_bf16`` and then widened."""
    if isinstance(tbl, Q4Tensor):
        return _dequant_q4_bf16(tbl).float()
    if isinstance(tbl, Q8Tensor):
        return dequantize_q8_0(tbl, axis=-2)
    return tbl.to(torch.float32)


def prepare_head(p: dict) -> dict:
    """An embedding dict with its tied head's f32 operand made once
    (``head_f32``), which ``logits_head`` would otherwise make at every
    call: 81.8 MB written a decode step for whisper-tiny.en's Q8_0 or Q4_0
    table."""
    return {**p, "head_f32": tied_head_f32(p["table"])}


def logits_head(p: dict, x: torch.Tensor, vocab: int,
                softcap: Optional[float] = None,
                head=None) -> torch.Tensor:
    """Project to the padded vocab in f32; padding ids get a large
    negative logit. ``head`` (d, padded vocab), where the model has an
    untied one, is ``mm`` in f32; else the tied table: x @ table^T in
    f32 (``tied_head_f32``, or ``p["head_f32"]`` where prepared). A Q4
    table (the draft's) is widened to bf16 and multiplied with
    bf16-rounded x as f32 operands: each product of two bf16 values is
    exact in f32, so this is the reference's bf16 x bf16 -> f32 einsum,
    accumulated in f32 and never rounded to bf16."""
    if head is not None:
        y = mm(x, head, torch.float32)
    else:
        tbl = p["table"]
        w = prepared(p, "head_f32", lambda: tied_head_f32(tbl))
        xf = x.to(torch.bfloat16).float() if isinstance(tbl, Q4Tensor) \
            else x.to(torch.float32)
        y = xf @ w.T
    if softcap is not None:
        y = softcap * torch.tanh(y / softcap)
    vp = y.shape[-1]
    pad_mask = torch.arange(vp, device=y.device) >= vocab
    return y - 1e9 * pad_mask.to(y.dtype)


def _r(t: torch.Tensor) -> torch.Tensor:
    return t.to(_BF16).to(_F32)


# jax evaluates an activation of a bf16 array op by op, each result
# rounded to bf16 and its constants too; the port rounds at the same
# places (bit-equal to jax.nn.silu / jax.nn.gelu on bf16), where one
# fused f32 evaluation would differ by a bf16 ulp in a fifth of the
# elements and drift the served tokens apart

def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu of a bf16 tensor: x * logistic(x)."""
    xf = x.to(_F32)
    return (xf * _r(1.0 / _r(1.0 + _r(torch.exp(-xf))))).to(_BF16)


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (tanh form) of a bf16 tensor, constants in bf16."""
    xf = x.to(_F32)
    inner = _r(xf + _r(0.044677734375 * _r(_r(xf * xf) * xf)))
    cdf = _r(0.5 * _r(1.0 + _r(torch.tanh(_r(0.796875 * inner)))))
    return (xf * cdf).to(_BF16)


def _act(name: str):
    """The activation ``name`` as jax computes it: op by op for a bf16
    tensor, in one pass otherwise (jax.nn.gelu defaults to the tanh
    approximation)."""
    fns = {"silu": (silu_bf16, F.silu),
           "gelu": (gelu_bf16, lambda t: F.gelu(t, approximate="tanh"))}
    per_op, fused = fns[name]
    return lambda t: per_op(t) if t.dtype == _BF16 else fused(t)


def init_mlp(gen: torch.Generator, d: int, ff: int, device,
             dtype=torch.float32) -> dict:
    """The gated MLP's ``up`` (d, ff), ``down`` (ff, d) and ``gate`` (d,
    ff) (the reference's ``init_mlp``, gated)."""
    return {"up": ninit(gen, (d, ff), d, device, dtype),
            "down": ninit(gen, (ff, d), ff, device, dtype),
            "gate": ninit(gen, (d, ff), d, device, dtype)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain two-layer MLP (Whisper); a ``gate`` weight makes it gated."""
    up = mm(x, p["up"])
    if "gate" in p:
        h = _act(act)(mm(x, p["gate"])) * up
    else:
        h = _act(act)(up)
    return mm(h, p["down"])
