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

The activations pass ``parallel.sharding.constrain`` at the reference's
points with its logical axes; without a mesh context, or on a plain
tensor, it returns its input.

A sharded step hands the forward DTensor parameters (``layer_params``:
the stacked leaves split into their layers, the rest gathered whole),
and every stack loop gathers one layer's slice at the start of the
function that computes the layer (``gather_layer``) while the step's
``gather_context`` is active, so a rank holds one layer's parameters
gathered at a time; under ``remat`` the slice is gathered again when
the backward recomputes the layer. Outside the context plain trees go
through untouched.

A serving tree (``Model.prepare_serving``) carries tensors that a
forward would otherwise derive from the weights at every call, such as
the tied head's f32 operand (``prepare_head``); ``prepared`` reads one
where it is present and makes it as before where it is not.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dtensor import is_dtensor
from repro_torch.kernels.api import current_context, dispatch, use_context
from repro_torch.parallel.sharding import constrain
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


class _SpecDevice:
    """The device an init function is given to walk its tree without
    drawing anything: every leaf comes back as a ``Spec``."""

    def __repr__(self):
        return "SPEC"


#: pass as ``device`` to an init function for its tree of ``Spec`` leaves
SPEC = _SpecDevice()


class Spec:
    """A parameter leaf's shape, dtype and logical axes (the reference's
    ``Param`` box without its value)."""
    __slots__ = ("shape", "dtype", "axes")

    def __init__(self, shape, dtype, axes):
        self.shape, self.dtype, self.axes = tuple(shape), dtype, tuple(axes)

    def __repr__(self):
        return f"Spec({self.shape}, {self.dtype}, {self.axes})"


def draw(gen: torch.Generator, shape, scale: float, device, dtype,
         axes: tuple):
    """N(0, 1) * ``scale``, drawn in float32 on the generator's device and
    stored in ``dtype`` on ``device`` (a CUDA generator and bf16 keep the
    f32 peak at one leaf); on ``SPEC`` the leaf's ``Spec``."""
    if device is SPEC:
        return Spec(shape, dtype, axes)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(device=device, dtype=dtype)


def ninit(gen: torch.Generator, shape, fan_in: int, device,
          dtype=torch.float32, *, axes: tuple) -> torch.Tensor:
    """Scaled-normal init, N(0, 1) / sqrt(fan_in) (``draw``)."""
    return draw(gen, shape, fan_in ** -0.5, device, dtype, axes)


def filled(shape, value: float, device, axes: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """A constant leaf (zeros, ones), or its ``Spec`` on ``SPEC``."""
    if device is SPEC:
        return Spec(shape, dtype, axes)
    return torch.full(shape, value, dtype=dtype, device=device)


def remat_on(cfg, mode: str) -> bool:
    """Whether a stack recomputes its layers' activations in the
    backward: ``cfg.remat`` in a train forward under autograd, never in
    prefill or decode."""
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def remat(fn, *args):
    """``fn(*args)``, its activations dropped and recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint`` with ``nothing_saveable``). The recomputation runs
    under this call's dispatch and gather contexts (the backward may run
    on another thread), so it binds what the forward bound (the
    grad-safe route in training) and gathers what it gathered."""
    ctx = current_context()
    gather = getattr(_GATHER, "ctx", None)

    def again(*a):
        with use_context(ctx), _gather_as(gather):
            return fn(*a)
    return checkpoint(again, *args, use_reentrant=False)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QTENSORS):
        return type(tree)(tree.q[i], tree.scale[i])
    return tree[i]


# ----------------------------------------------------------------------------
# Sharded parameters: one layer gathered at a time
# ----------------------------------------------------------------------------

_GATHER = threading.local()


@contextlib.contextmanager
def _gather_as(ctx):
    prev = getattr(_GATHER, "ctx", None)
    _GATHER.ctx = ctx
    try:
        yield
    finally:
        _GATHER.ctx = prev


def gather_context(grad_placements=None,
                   place_cache: Optional[Callable] = None):
    """While active, ``gather_layer`` gathers a layer's DTensor leaves
    whole (``gathered`` with ``grad_placements``) and ``keep_layer``
    passes a prefill's per-layer cache through ``place_cache``."""
    return _gather_as((grad_placements, place_cache))


def gathered(t: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """The DTensor ``t`` gathered whole onto every rank as a plain
    tensor: ``redistribute`` to replicated, then ``to_local``. Under
    autograd its gradient is read as ``grad_placements`` (partial sums
    over the data axes), which the gather's backward reduce-scatters
    onto ``t``'s placements."""
    from torch.distributed.tensor import Replicate
    full = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return full.to_local(grad_placements=grad_placements)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def gather_layer(tree):
    """One layer's parameters (``layer_slice``'s subtree) with each
    DTensor leaf gathered whole while a ``gather_context`` is active;
    ``tree`` itself otherwise (no copy, no collective)."""
    ctx = getattr(_GATHER, "ctx", None)
    if ctx is None:
        return tree
    return _map_leaves(lambda t: gathered(t, ctx[0]) if is_dtensor(t)
                       else t, tree)


def keep_layer(tree):
    """A prefill's new per-layer cache subtree, placed by the active
    ``gather_context``'s ``place_cache`` (as it is without one)."""
    ctx = getattr(_GATHER, "ctx", None)
    return tree if ctx is None or ctx[1] is None else ctx[1](tree)


def _contiguous_stride(shape: tuple) -> tuple:
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


class LayerShards:
    """A stacked DTensor leaf (L, ...) split into its L layers: its local
    shard unbound on the layer axis once, each layer a DTensor of the
    leaf's placements one dim lower. ``layer_slice`` indexes it as it
    indexes the stacked leaf. The layers' gradients go back through the
    one ``unbind``, whose backward stacks them once; indexing the stacked
    leaf L times instead would write L zero-filled shards of the stack's
    size and sum them."""

    def __init__(self, leaf: torch.Tensor):
        from torch.distributed.tensor import DTensor, Shard
        if any(p.is_shard() and p.dim == 0 for p in leaf.placements):
            raise ValueError("a stacked leaf's layer axis is sharded")
        placements = [Shard(p.dim - 1) if p.is_shard() else p
                      for p in leaf.placements]
        shape = tuple(leaf.shape[1:])
        self.shape = leaf.shape
        self._layers = [
            DTensor.from_local(t, leaf.device_mesh, placements,
                               run_check=False, shape=shape,
                               stride=_contiguous_stride(shape))
            for t in leaf.to_local().unbind(0)]

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._layers[i]


def layer_params(params: dict, axes: dict, grad_placements=None) -> dict:
    """The tree a forward under ``gather_context`` takes from the
    parameter tree ``params`` (``axes``: its logical axes): each DTensor
    leaf whose first axis is ``layers`` as ``LayerShards``, gathered a
    layer at a time by the stack loops, and every other DTensor leaf
    (embeddings, head, final norms, the Whisper frontend, the hybrid's
    shared block) gathered whole once; plain leaves as they are."""
    def one(t, ax):
        if not is_dtensor(t):
            return t
        if ax[:1] == ("layers",):
            return LayerShards(t)
        return gathered(t, grad_placements)
    return {k: layer_params(v, axes[k], grad_placements)
            if isinstance(v, dict) else one(v, axes[k])
            for k, v in params.items()}


def stack_layers(trees: list):
    """Stack per-layer parameter (or cache) trees on a new leading axis:
    the inverse of ``layer_slice``. ``Spec`` leaves gain the ``layers``
    axis (the reference's ``stack_axes``); DTensor leaves stack their
    local shards, the placements one dim higher."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], Spec):
        return Spec((len(trees),) + trees[0].shape, trees[0].dtype,
                    ("layers",) + trees[0].axes)
    if is_dtensor(trees[0]):
        from torch.distributed.tensor import DTensor, Shard
        one = trees[0]
        shape = (len(trees),) + tuple(one.shape)
        return DTensor.from_local(
            torch.stack([t.to_local() for t in trees]), one.device_mesh,
            [Shard(p.dim + 1) if p.is_shard() else p
             for p in one.placements],
            run_check=False, shape=shape, stride=_contiguous_stride(shape))
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

def init_rmsnorm(d: int, device, axes: tuple = ("embed",)) -> torch.Tensor:
    return filled((d,), 1.0, device, axes)


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
    return {"table": ninit(gen, (pad_vocab(vocab), d), d, device, dtype,
                           axes=("vocab", "param_embed"))}


def embed(p: dict, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token rows of the (padded-vocab, d) table, in ``compute_dtype``. A
    Q4 table is widened to bf16, as the reference's ``embed`` does."""
    tbl = p["table"]
    if isinstance(tbl, Q4Tensor):
        x = _q4_rows_bf16(tbl, tokens).to(compute_dtype)
    else:
        x = take_rows(tbl, tokens, compute_dtype)
    return constrain(x, "batch", "q_seq", "embed")


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
    return constrain(y - 1e9 * pad_mask.to(y.dtype), "batch", "q_seq",
                     "vocab")


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
    return {"up": ninit(gen, (d, ff), d, device, dtype,
                        axes=("param_embed", "ff")),
            "down": ninit(gen, (ff, d), ff, device, dtype,
                          axes=("ff", "param_embed")),
            "gate": ninit(gen, (d, ff), d, device, dtype,
                          axes=("param_embed", "ff"))}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain two-layer MLP (Whisper); a ``gate`` weight makes it gated."""
    up = constrain(mm(x, p["up"]), "batch", "q_seq", "ff")
    if "gate" in p:
        g = _act(act)(mm(x, p["gate"]))
        h = constrain(g, "batch", "q_seq", "ff") * up
    else:
        h = _act(act)(up)
    return constrain(mm(h, p["down"]), "batch", "q_seq", "embed")
