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
through untouched. A meshed decode step's context carries its rows
(``MeshRows``): each decode block then fetches one layer's cache, this
rank's rows gathered over every other sharded mesh axis
(``gather_cache_layer``), and writes what it wrote back into the local
shards (``write_cache_layer``); outside it the block reads and writes
the stacked pool at its layer, as the serving engine's tick does.

A meshed serving step's context also carries its ``model`` axis
(``parallel.model_axis``). The split units then take their ``model``
shards instead of the whole gather (``unit_form``, ``split_unit``): the
attention its query heads (and KV heads, or the whole K/V where the
cache splits head_dim), the MLP its columns, the embedding its
vocabulary rows, the untied head its vocabulary columns, the MoE its
experts or each expert's columns, a mamba or mLSTM block its inner
channels and heads, an sLSTM block its heads; where the heads do not
divide ``model`` (the reference's ``serve_row_tp``), each product its
rows along d_model (or the inner dim it contracts); each shard a plain
tensor that says so (``model_dim``). The split layers are plain
functions of their shard plus a collective: ``row_parallel`` /
``row_parallel_mm`` (the attention's ``wo``, the MLP's ``down``, the
MoE's combine or ``down``, the mamba block's ``wo``, every product split
along d_model: one all-reduce, one rounding, a block of rows at a time),
the vocab-parallel embedding's all-reduce, a split ``rmsnorm``'s mean
square, ``vocab_offset`` and ``sharded_argmax``.

A serving tree (``Model.prepare_serving``) carries tensors that a
forward would otherwise derive from the weights at every call, such as
the tied head's f32 operand (``prepare_head``); ``prepared`` reads one
where it is present and makes it as before where it is not.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Any, Callable, NamedTuple, Optional

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


class _Gather(NamedTuple):
    """A ``gather_context``'s state."""
    grad_placements: Any
    place_cache: Optional[Callable]
    rows: Optional["MeshRows"]
    model: Any        # the split's ModelAxis (parallel.model_axis)
    split_attention: bool


@contextlib.contextmanager
def _gather_as(ctx):
    prev = getattr(_GATHER, "ctx", None)
    _GATHER.ctx = ctx
    try:
        yield
    finally:
        _GATHER.ctx = prev


def gather_context(grad_placements=None,
                   place_cache: Optional[Callable] = None,
                   rows: Optional["MeshRows"] = None, model=None,
                   split_attention: bool = True):
    """While active, ``gather_layer`` gathers a layer's DTensor leaves
    whole (``gathered`` with ``grad_placements``), ``keep_layer``
    passes a prefill's per-layer cache through ``place_cache``, and with
    ``rows`` (a meshed decode step's) ``gather_cache_layer`` /
    ``write_cache_layer`` read and write the sharded cache a layer at a
    time. With ``model`` (a meshed serving step's ``ModelAxis`` of more
    than one rank) the layers every family shares take their ``model``
    shards instead (``split_unit``); ``split_attention=False`` keeps the
    attention whole (a quantized cache, whose planes the mesh leaves
    whole)."""
    if model is not None and model.size == 1:
        model = None
    return _gather_as(_Gather(grad_placements, place_cache, rows, model,
                              split_attention))


def _active() -> Optional[_Gather]:
    return getattr(_GATHER, "ctx", None)


def model_axis():
    """The active split's ``ModelAxis`` (None outside a meshed serving
    step, or where ``model`` is one rank)."""
    ctx = _active()
    return None if ctx is None else ctx.model


def gathered(t: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """The DTensor ``t`` gathered whole onto every rank as a plain
    tensor: ``redistribute`` to replicated, then ``to_local``. Under
    autograd its gradient is read as ``grad_placements`` (partial sums
    over the data axes), which the gather's backward reduce-scatters
    onto ``t``'s placements."""
    from torch.distributed.tensor import Replicate
    full = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return full.to_local(grad_placements=grad_placements)


def gather_layer(tree):
    """One layer's parameters (``layer_slice``'s subtree) with each
    DTensor leaf gathered whole while a ``gather_context`` is active (or,
    under a split, the shared layers' leaves as their ``model`` shards:
    ``split_unit``); ``tree`` itself otherwise (no copy, no
    collective)."""
    ctx = _active()
    if ctx is None:
        return tree
    return _gather_tree(tree, None, ctx, ctx.grad_placements)


def _gather_tree(tree, name, ctx: _Gather, grad_placements):
    """``tree`` (the subtree at key ``name``) with each unit the active
    split takes split (``unit_form``) and every other DTensor leaf
    gathered whole."""
    if ctx.model is not None:
        form = unit_form(name, tree, ctx)
        if form is not None:
            return split_unit(tree, ctx.model, form, grad_placements, name)
    if isinstance(tree, dict):
        return {k: _gather_tree(v, k, ctx, grad_placements)
                for k, v in tree.items()}
    return gathered(tree, grad_placements) if is_dtensor(tree) else tree


def keep_layer(tree):
    """A prefill's new per-layer cache subtree, placed by the active
    ``gather_context``'s ``place_cache`` (as it is without one)."""
    ctx = _active()
    return tree if ctx is None or ctx.place_cache is None \
        else ctx.place_cache(tree)


# ----------------------------------------------------------------------------
# The split over ``model``: the layers every family shares on their shards
# ----------------------------------------------------------------------------

#: the keys of an attention unit in a layer tree
ATTN_UNITS = ("attn", "self_attn", "cross_attn")

#: each split form's leaves that take their ``model`` shard, with the
#: tensor dim the shard splits; a unit's other leaves are gathered whole.
#: ``heads``: the query and KV heads (Megatron's column-parallel Q/K/V and
#: row-parallel output), and an sLSTM block's FFN columns (its heads'
#: gate weights, which the serve rules leave whole, sliced locally);
#: ``head_dim``: the query heads, and K and V on their head_dim slice
#: (their KV heads do not divide ``model``; the cache splits head_dim);
#: ``ff``: the MLP's columns; ``vocab`` / ``vocab_cols``: the embedding
#: table's rows / the untied head's columns; ``experts``: the MoE's experts
#: (expert parallelism), ``expert_ff``: each expert's FFN columns (the
#: router whole either way); ``inner``: a mamba block's inner channels and
#: SSM heads (``wB``, ``wC`` and their conv taps, which the serve rules
#: leave off ``model``, whole), or an mLSTM block's inner channels and
#: heads; ``param_embed``: the reference's ``serve_row_tp`` (the heads do
#: not divide ``model``), every product split along d_model, or along the
#: inner dim it contracts (an xLSTM block's, the MLP's ``down``), ``wo``
#: along head_dim where it divides ``model`` (the cache splits head_dim),
#: else along d_model (a tuple: the first dim ``model`` divides); the
#: Whisper frontend and decoder positions too
FORMS = {
    "heads": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0,
              "bv": 0, "w_up": 1, "w_down": 0},
    "head_dim": {"wq": 1, "wk": 2, "wv": 2, "wo": 0, "bq": 0, "bk": 1,
                 "bv": 1},
    "ff": {"up": 1, "gate": 1, "down": 0},
    "vocab": {"table": 0},
    "vocab_cols": {"lm_head": 1},
    "experts": {"gate": 0, "up": 0, "down": 0},
    "expert_ff": {"gate": 2, "up": 2, "down": 1},
    "inner": {"wz": 1, "wx": 1, "conv_x": 1, "out_norm": 0, "wo": 0,
              "wdt": 1, "dt_bias": 0, "A_log": 0, "D": 0,
              "w_up": 1, "w_gate": 1, "wq": 0, "wk": 0, "wv": 0, "wi": 0,
              "wf": 0, "w_down": 0},
    "param_embed": {"wq": 0, "wk": 0, "wv": 0, "wo": (1, 2), "up": 0,
                    "gate": 0, "down": 0, "lm_head": 0, "w_up": 0,
                    "w_gate": 0, "wi": 0, "wf": 0, "w_down": 0, "w": 0,
                    "frontend": 0, "dec_pos": 1},
}

#: the leaves a unit must have to take a form (the form's other leaves
#: that it has must lie as the form says too)
_NEED = {
    ("attention", "heads"): ("wq", "wk", "wv", "wo"),
    ("attention", "head_dim"): ("wq", "wk", "wv", "wo"),
    ("attention", "param_embed"): ("wq", "wk", "wv", "wo"),
    ("mlp", "ff"): ("up", "down"),
    ("mlp", "param_embed"): ("up", "down"),
    ("embed", "vocab"): ("table",),
    ("moe", "experts"): ("gate", "up", "down"),
    ("moe", "expert_ff"): ("gate", "up", "down"),
    ("mamba", "inner"): ("wz", "wx", "conv_x", "out_norm", "wo", "wdt",
                         "dt_bias", "A_log", "D"),
    ("mlstm", "inner"): ("w_up", "w_gate", "wq", "wk", "wv", "wi", "wf",
                         "out_norm", "w_down"),
    ("mlstm", "param_embed"): ("w_up", "w_gate", "wq", "wk", "wv", "wi",
                               "wf", "w_down"),
    ("slstm", "heads"): ("w_up", "w_down"),
    ("slstm", "param_embed"): ("w_up", "w_down"),
}

#: an sLSTM block's gate subtrees
SLSTM_GATES = ("i", "f", "z", "o")

_SPLITS: collections.Counter = collections.Counter()
_WHOLE: collections.Counter = collections.Counter()


def split_counts() -> collections.Counter:
    """(unit, form) -> how many times a split step took that unit in that
    form (``"whole"``: gathered whole over ``model``), since the last
    ``reset_split_counts``."""
    return collections.Counter(_SPLITS)


def whole_leaf_counts() -> collections.Counter:
    """(unit, leaf) -> how many times a split step gathered that leaf of
    a unit it split whole over ``model`` (a DTensor the placements put
    on ``model`` that the unit's form does not take as a shard), since
    the last ``reset_split_counts``. A gate subtree's leaf is named
    ``gate.leaf``."""
    return collections.Counter(_WHOLE)


def reset_split_counts() -> None:
    """Clear ``split_counts`` and ``whole_leaf_counts``."""
    _SPLITS.clear()
    _WHOLE.clear()


def _model_shard_dim(t) -> Optional[int]:
    """The tensor dim a DTensor's placement on the ``model`` mesh axis
    shards, else None."""
    if not is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    p = t.placements[names.index("model")]
    return p.dim if p.is_shard() else None


def _on(dim, want) -> bool:
    """Whether a leaf placed on ``model`` along ``dim`` lies as a form's
    entry ``want`` (a dim, or a tuple of the dims it may take) says."""
    return dim in want if isinstance(want, tuple) else dim == want


def _takes(tree: dict, unit: str, form: str) -> bool:
    """Whether the ``unit`` subtree ``tree`` has the leaves ``form``
    needs and every leaf of ``form`` that it has is placed on ``model``
    along the form's dim."""
    dims = FORMS[form]
    return all(k in tree for k in _NEED[(unit, form)]) and all(
        _on(_model_shard_dim(tree[k]), d) for k, d in dims.items()
        if k in tree)


#: the top-level leaves the split may take (a key of ``FORMS``'s forms):
#: the untied head, the Whisper frontend and decoder positions
_LEAF_UNITS = {"lm_head": "head", "frontend": "frontend",
               "dec_pos": "dec_pos"}


def _unit(name, tree) -> Optional[str]:
    """The unit the split may take at key ``name`` of a layer (see
    ``unit_form``), else None."""
    if name in ATTN_UNITS and isinstance(tree, dict) and "wq" in tree:
        return "attention"
    if name in ("mlp", "embed", "moe", "mamba", "mlstm", "slstm") \
            and isinstance(tree, dict):
        return name
    if name in _LEAF_UNITS and not isinstance(tree, dict):
        return _LEAF_UNITS[name]
    return None


def unit_form(name, tree, ctx: Optional[_Gather] = None) -> Optional[str]:
    """The form in which the split takes the subtree ``tree`` at key
    ``name`` of a layer, or None where ``name`` is no unit it splits. A
    unit whose placements do not give a form is taken whole (counted as
    ``"whole"``): decided from the leaves' placements and global shapes
    and the mesh alone, so every rank takes the same branch. The units:
    attention (``ATTN_UNITS``: ``heads`` where the query and KV heads
    divide ``model``, else ``head_dim`` where the cache splits head_dim
    and each rank's query heads read one KV head, else ``param_embed``
    where the heads do not divide ``model``, the reference's
    ``serve_row_tp``; whole where the cache is quantized), the dense MLP
    (``mlp``: ``ff``, or ``param_embed``), the embedding (``embed``:
    ``vocab``), the untied head (``lm_head``: ``vocab_cols``, or
    ``param_embed``), the MoE (``moe``: ``experts`` where the experts
    divide ``model``, else ``expert_ff``; quantized experts, which a
    mesh does not place, whole), a mamba block (``mamba``: ``inner``
    where its inner channels and SSM heads both lie on ``model``), the
    xLSTM blocks (``mlstm``: ``inner`` where its heads divide ``model``,
    ``slstm``: ``heads`` there; both ``param_embed`` where they do not)
    and the Whisper frontend and decoder positions (``frontend``,
    ``dec_pos``: ``param_embed``, under ``serve_row_tp`` alone).
    Everything else (the norms, the biases) is gathered whole. A
    shard-by-shard run's axis that names ``forms`` takes each unit of
    whole plain weights in the form named there."""
    ctx = ctx or _active()
    if ctx is None or ctx.model is None:
        return None
    unit = _unit(name, tree)
    if unit is None:
        return None
    size = ctx.model.size
    form = None
    if ctx.model.forms is not None:
        form = ctx.model.forms.get(unit)
        if unit == "attention" and not ctx.split_attention:
            form = None
    elif unit == "attention":
        if ctx.split_attention and _takes(tree, unit, "heads"):
            form = "heads"
        elif ctx.split_attention and _takes(tree, unit, "head_dim") \
                and size % tree["wk"].shape[1] == 0:
            form = "head_dim"
        elif ctx.split_attention and _takes(tree, unit, "param_embed"):
            form = "param_embed"
    elif unit in ("mlp", "moe"):
        form = next((f for f in ("ff", "param_embed", "experts",
                                 "expert_ff")
                     if (unit, f) in _NEED and _takes(tree, unit, f)), None)
    elif unit == "embed":
        form = "vocab" if _takes(tree, unit, "vocab") else None
    elif unit == "mamba":
        form = "inner" if _takes(tree, unit, "inner") else None
    elif unit == "mlstm":
        if tree["wi"].shape[1] % size == 0 and _takes(tree, unit, "inner"):
            form = "inner"
        elif _takes(tree, unit, "param_embed"):
            form = "param_embed"
    elif unit == "slstm":
        gates = {_model_shard_dim(tree[g]["w"]) for g in SLSTM_GATES}
        if gates == {None} and tree["i"]["w"].shape[1] % size == 0 \
                and _takes(tree, unit, "heads"):
            form = "heads"
        elif gates == {0} and _takes(tree, unit, "param_embed"):
            form = "param_embed"
    else:
        dim = _model_shard_dim(tree)
        form = next((f for f in ("vocab_cols", "param_embed")
                     if FORMS[f].get(name) == dim), None) \
            if dim is not None else None
    if form is None and unit in ("frontend", "dec_pos"):
        return None    # off ``model`` but under serve_row_tp: not a unit
    _SPLITS[(unit, form or "whole")] += 1
    return form


def model_local(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``, this rank's ``model`` shard along ``dim``, as a view that
    says so (``model_dim``)."""
    v = t.view(t.shape)
    v._model_dim = dim
    return v


def model_dim(t) -> Optional[int]:
    """The dim along which ``t`` is this rank's ``model`` shard
    (``model_local``), else None: a whole tensor."""
    return getattr(t, "_model_dim", None)


def _local_shard(t, dim, axis) -> torch.Tensor:
    """This rank's ``model`` shard of ``t`` along ``dim`` (a tuple: the
    DTensor's own placement, or the first of its dims that ``model``
    divides): a DTensor's local tensor (gathered over any other sharded
    mesh axis first), or a whole plain tensor's chunk ``axis.rank``."""
    if isinstance(dim, tuple):
        dim = _model_shard_dim(t) if is_dtensor(t) else next(
            d for d in dim if t.shape[d] % axis.size == 0)
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        m = t.device_mesh.mesh_dim_names.index("model")
        want = [p if i == m else Replicate()
                for i, p in enumerate(t.placements)]
        if list(t.placements) != want:
            t = t.redistribute(t.device_mesh, want)
        return model_local(t.to_local(), dim)
    return model_local(t.chunk(axis.size, dim)[axis.rank], dim)


def split_unit(tree, axis, form: str, grad_placements=None,
               name: str = "lm_head"):
    """The unit ``tree`` (a dict at key ``name`` of a layer, or the
    top-level leaf there: the head, the Whisper frontend or decoder
    positions) in ``form``: its form leaves as this rank's ``model``
    shards (``model_local``; an sLSTM block's gate subtrees leaf by
    leaf), every other DTensor leaf gathered whole (those on ``model``
    counted in ``whole_leaf_counts``). Takes DTensors (a meshed step's)
    or whole plain tensors, which it chunks as the placements would (a
    shard-by-shard run: ``parallel.model_axis.run_shards``)."""
    dims = FORMS[form]
    if not isinstance(tree, dict):
        return _local_shard(tree, dims[name], axis)
    return _split_tree(tree, axis, dims, grad_placements,
                       _unit(name, tree) or name, "")


def _split_tree(tree: dict, axis, dims: dict, grad_placements, unit: str,
                prefix: str) -> dict:
    """``split_unit`` of a dict ``tree`` of ``unit``, its nested dicts'
    leaves named ``prefix`` + key in ``whole_leaf_counts``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _split_tree(v, axis, dims, grad_placements, unit,
                                 f"{prefix}{k}.")
        elif k in dims:
            out[k] = _local_shard(v, dims[k], axis)
        elif is_dtensor(v):
            if _model_shard_dim(v) is not None:
                _WHOLE[(unit, prefix + k)] += 1
            out[k] = gathered(v, grad_placements)
        else:
            out[k] = v
    return out


def attention_form(p) -> Optional[str]:
    """The form of an attention unit as the split handed it over:
    ``heads``, ``head_dim``, ``param_embed``, or None (whole)."""
    dim = model_dim(p["wq"])
    if dim is None:
        return None
    if dim == 0:
        return "param_embed"
    return "heads" if model_dim(p["wk"]) == 1 else "head_dim"


def row_parallel(partial: torch.Tensor, dtype=_BF16) -> torch.Tensor:
    """A row-parallel product's output: one all-reduce (sum) over
    ``model`` of this rank's f32 partial, then one rounding to
    ``dtype``."""
    return model_axis().all_reduce(partial).to(dtype)


#: the rows (positions of every batch row) a row-parallel product sums
#: over ``model`` at a time: its f32 partial then holds no more than the
#: bf16 product of a prefill's rows it stands for
ROW_BLOCK = 4096


def row_parallel_mm(x: torch.Tensor, w: torch.Tensor, dtype=_BF16,
                    compute_dtype=_BF16) -> torch.Tensor:
    """x @ w where x (..., k) holds this rank's ``model`` slice of the
    contraction and w (k, ...) its rows: the f32 partial (``mm``'s
    ``out_dtype``; a 3-D weight flattened past its first dim), summed
    over ``model`` and rounded once to ``dtype`` (``row_parallel``),
    ``ROW_BLOCK`` rows of x at a time."""
    lead, k = x.shape[:-1], x.shape[-1]
    w2 = w.reshape(w.shape[0], -1)

    def part(rows):
        return row_parallel(mm(rows, w2, compute_dtype, out_dtype=_F32),
                            dtype)
    m = x.numel() // k
    if m <= ROW_BLOCK:
        y = part(x)
    else:
        x2 = x.reshape(m, k)
        y = torch.empty((m, w2.shape[1]), dtype=dtype, device=x.device)
        for i in range(0, m, ROW_BLOCK):
            y[i:i + ROW_BLOCK] = part(x2[i:i + ROW_BLOCK])
    return y.reshape(*lead, *w.shape[1:])


def by_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a map ``fn`` of each row of x (..., d) alone (a
    position-wise unit), ``ROW_BLOCK`` rows at a time: its temporaries
    then hold a block's rows, not a prefill's."""
    lead, d = x.shape[:-1], x.shape[-1]
    m = x.numel() // d
    if m <= ROW_BLOCK:
        return fn(x)
    x2, out = x.reshape(m, d), None
    for i in range(0, m, ROW_BLOCK):
        y = fn(x2[i:i + ROW_BLOCK])
        if out is None:
            out = torch.empty((m, y.shape[-1]), dtype=y.dtype,
                              device=y.device)
        out[i:i + ROW_BLOCK] = y
    return out.reshape(*lead, out.shape[-1])


def model_chunk(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's ``model`` chunk of the whole tensor ``t`` along
    ``dim`` (a d_model slice of an activation, a head_dim slice),
    contiguous, as a kernel takes it."""
    axis = model_axis()
    return t.chunk(axis.size, dim)[axis.rank].contiguous()


def vocab_offset(n_local: int) -> int:
    """The first id of this rank's vocabulary shard of ``n_local`` ids."""
    return model_axis().rank * n_local


def sharded_argmax(local: torch.Tensor) -> torch.Tensor:
    """``torch.argmax`` over the last dim of the logits whose columns are
    split over ``model`` (``local``: this rank's), as int32: this rank's
    (max, first index), then one all-gather of the (rows, tp) pairs; the
    first rank holding the largest value gives the lowest global index
    among equal maxima, as ``torch.argmax`` returns. Indices travel as
    f32, exact below 2**24."""
    idx = torch.argmax(local, dim=-1)
    val = local.gather(-1, idx[..., None]).to(_F32)
    glob = (idx[..., None] + vocab_offset(local.shape[-1])).to(_F32)
    pairs = model_axis().all_gather(torch.stack([val, glob], -1), dim=-2)
    best = torch.argmax(pairs[..., 0], dim=-1, keepdim=True)
    return pairs[..., 1].gather(-1, best)[..., 0].to(torch.int32)


# ----------------------------------------------------------------------------
# The sharded cache of a meshed serving step: a rank's rows, a layer at a time
# ----------------------------------------------------------------------------

#: the key sets of a KV-plane dict in a cache tree (bf16, q8_0, q4_0)
KV_PLANE_KEYS = ({"k", "v"}, {"kq", "ks", "vq", "vs"},
                 {"kp", "ks", "vp", "vs"})


class MeshRows:
    """The rows of a meshed serving step's global batch of ``n`` that
    this rank runs, and the moves between them and the cache's shards.
    ``split``: the data mesh dims (``data_axes``) divide the batch, and
    a rank runs its block of it, pod-major as DTensor shards dim 0 over
    several mesh dims; else (the divisibility fallback, which leaves the
    cache's batch dim whole too) every rank runs every row. ``model``:
    the mesh dim of the ``model`` axis (None without one), whose shard of
    a cache leaf a split attention keeps (``keep_model``)."""

    def __init__(self, mesh, data_axes: tuple, n: int):
        self.mesh, self.n = mesh, n
        names = mesh.mesh_dim_names
        self.data_dims = tuple(names.index(a) for a in data_axes)
        self.model = names.index("model") if "model" in names else None
        n_dp = math.prod(mesh.size(m) for m in self.data_dims)
        self.split = n_dp > 1 and n % n_dp == 0
        idx = 0
        coords = mesh.get_coordinate()
        for m in self.data_dims:
            idx = idx * mesh.size(m) + coords[m]
        self.count = n // n_dp if self.split else n
        self.start = idx * self.count if self.split else 0

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` (the global batch on dim 0): a view."""
        return t.narrow(0, self.start, self.count) if self.split else t

    def own_rows(self, placements) -> bool:
        """Whether ``placements`` shard dim 0 over the data dims, so that
        the local shard holds this rank's rows only."""
        return self.split and any(
            p.is_shard() and p.dim == 0 and m in self.data_dims
            for m, p in enumerate(placements))

    def all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of this rank's rows (dim 0) as every rank's, all-gathered
        over the data dims (``t`` itself where every rank runs every
        row)."""
        if not self.split:
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(0) if m in self.data_dims else Replicate()
              for m in range(self.mesh.ndim)]
        shape = (self.n,) + tuple(t.shape[1:])
        return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape)
                                  ).full_tensor()

    def _kept(self, keep_model: bool) -> tuple:
        return (self.model,) if keep_model and self.model is not None \
            else ()

    def block(self, t: torch.Tensor, placements,
              keep_model: bool = False) -> torch.Tensor:
        """The local shard, by ``placements`` (one layer's), of ``t``:
        this rank's rows at full width (at its ``model`` shard already
        with ``keep_model``). A leaf whose rows the placements leave
        whole (the MoE routing counts) takes every rank's rows
        (``all_rows``). A view of ``t`` where that gathers nothing."""
        own = self.own_rows(placements)
        if self.split and not own:
            t = self.all_rows(t)
        coords = self.mesh.get_coordinate()
        kept = self._kept(keep_model)
        for m, p in enumerate(placements):
            if p.is_shard() and m not in kept \
                    and not (own and m in self.data_dims):
                t = t.chunk(self.mesh.size(m), dim=p.dim)[coords[m]]
        return t

    def global_shape(self, t: torch.Tensor) -> tuple:
        """The global leaf's shape of ``t``: this rank's rows, at full
        width or at its ``model`` shard where ``model_dim`` says so."""
        shape = [self.n] + list(t.shape[1:])
        if model_dim(t) is not None:
            shape[model_dim(t)] *= self.mesh.size(self.model)
        return tuple(shape)

    def place(self, t: torch.Tensor, placements) -> torch.Tensor:
        """``t`` (``global_shape``'s: this rank's rows of a global leaf of
        ``n`` rows, whole or at its ``model`` shard) as the DTensor of
        ``placements``, built from this rank's block (``block``):
        nothing is distributed from a whole tensor."""
        from torch.distributed.tensor import DTensor
        local = model_dim(t)
        if local is not None:
            p = placements[self.model]
            if not (p.is_shard() and p.dim == local):
                raise ValueError(f"a cache leaf split along dim {local} "
                                 f"is placed {placements}")
        shape = self.global_shape(t)
        return DTensor.from_local(
            self.block(t, placements, local is not None).contiguous(),
            self.mesh, list(placements), run_check=False, shape=shape,
            stride=_contiguous_stride(shape))

    def gather(self, leaf: torch.Tensor, i: int,
               keep_model: bool = False) -> torch.Tensor:
        """Layer ``i`` of the stacked cache DTensor ``leaf``: this rank's
        rows, gathered over every other sharded mesh dim (but ``model``
        with ``keep_model``: a split attention reads its shard), as a
        plain tensor (a view of the local shard where nothing is to
        gather)."""
        from torch.distributed.tensor import DTensor, Replicate
        pl = _layer_placements(leaf)
        own = self.own_rows(pl)
        kept = self._kept(keep_model)
        keep = [p if (own and m in self.data_dims) or m in kept
                else Replicate() for m, p in enumerate(pl)]
        local = leaf.to_local()[i]
        if keep != pl:
            shape = tuple(leaf.shape[1:])
            local = DTensor.from_local(
                local, self.mesh, pl, run_check=False, shape=shape,
                stride=_contiguous_stride(shape)
            ).redistribute(self.mesh, keep).to_local()
        return local if own else self.take(local)

    def write(self, leaf: torch.Tensor, i: int, new: torch.Tensor,
              at: Optional[torch.Tensor], keep_model: bool = False) -> None:
        """Write ``new`` (layer ``i`` of ``leaf`` as ``gather`` gives it,
        written by a block) into this rank's slice of layer ``i`` of
        ``leaf``'s local shard, in place: the positions ``at`` ((rows,
        Q), on dim 1) of each row, or the whole layer (``at`` None)."""
        pl = _layer_placements(leaf)
        dst = leaf.to_local()[i]
        if at is None:
            dst.copy_(self.block(new, pl, keep_model))
            return
        lanes = torch.arange(at.shape[0], device=at.device)[:, None]
        dst.index_put_((lanes, at), self.block(new[lanes, at], pl,
                                               keep_model))


def _layer_placements(leaf: torch.Tensor) -> list:
    """The placements of one layer of a stacked cache DTensor (each
    shard one dim lower; its layer dim is never sharded)."""
    from torch.distributed.tensor import Shard
    if any(p.is_shard() and p.dim == 0 for p in leaf.placements):
        raise ValueError("a stacked cache leaf's layer axis is sharded")
    return [Shard(p.dim - 1) if p.is_shard() else p for p in leaf.placements]


def meshed_rows() -> Optional[MeshRows]:
    """The active meshed serving step's ``MeshRows`` (None outside one)."""
    ctx = _active()
    return None if ctx is None else ctx.rows


def _keeps(keep_model, key) -> bool:
    """Whether the cache leaf at key ``key`` keeps its ``model`` shard:
    ``keep_model`` a bool for every leaf, or the keys that keep it."""
    return keep_model if isinstance(keep_model, bool) else key in keep_model


def gather_cache_layer(pool, i: int, keep_model=False):
    """(tree, index): a decode block's cache of layer ``i`` of the stacked
    cache subtree ``pool``, as a pool and the layer's index in it, which
    the block reads and writes there. Outside a meshed decode step
    ``(pool, i)``: the stacked pool itself, written in place at layer
    ``i`` (no copy, no collective, no op). Under one, a one-layer pool
    and 0: each leaf's layer ``i`` as a plain (1, rows, ...) tensor of
    this rank's rows, gathered over every other sharded mesh dim
    (``model`` on the KV heads, head_dim, heads, ssm heads or inner dim;
    ``MeshRows.gather``), but ``model`` with ``keep_model`` (the block's
    attention is split: it reads its shard; or the keys of the leaves
    that keep it, a split mamba block's ``h``, an sLSTM block's state
    but ``m`` where the cache does not place that on ``model``), which
    ``write_cache_layer`` writes back."""
    rows = meshed_rows()
    if rows is None:
        return pool, i

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return rows.gather(t, i, _keeps(keep_model, key))[None]
    return walk(pool, None), 0


def write_cache_layer(pool, i: int, layer, pos=None, q: int = 1,
                      keep_model=False) -> None:
    """After a decode block wrote ``layer`` (``gather_cache_layer``'s
    one-layer pool of ``pool``, taken with the same ``keep_model``),
    under a meshed decode step: write what it wrote into this rank's
    slice of the local shards of ``pool``'s layer ``i``, the K/V planes'
    rows at positions ``pos`` + 0 .. q - 1 (``pos`` a scalar or one a
    row) and every other leaf whole (recurrent state, routing counts). A
    leaf whose batch dim the mesh leaves whole (the MoE routing counts)
    takes every rank's rows, gathered over the data axes, so it holds
    the global batch's counts on every rank. Nothing outside a meshed
    decode step: the block wrote the pool."""
    rows = meshed_rows()
    if rows is None:
        return

    def walk(dst, new, planes, key):
        if isinstance(dst, dict):
            inner = set(dst) in KV_PLANE_KEYS
            for k in dst:
                walk(dst[k], new[k], inner, k)
        else:
            rows.write(dst, i, new[0], at if planes else None,
                       _keeps(keep_model, key))

    at = None
    if pos is not None:
        first = next(_leaves(layer))
        posv = torch.as_tensor(pos, device=first.device).reshape(-1) \
            .expand(first.shape[1])
        at = posv[:, None] + torch.arange(q, device=first.device)[None, :]
    walk(pool, layer, False, None)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
    shared block) gathered whole once, or, under a split, taken as its
    unit's ``model`` shards (``unit_form``: the embedding, the untied
    head, the shared block's attention and MLP, the Whisper frontend and
    decoder positions); plain leaves as they
    are."""
    ctx = _active() or _Gather(None, None, None, None, True)

    def stacked(ax) -> bool:
        if isinstance(ax, dict):
            return any(stacked(v) for v in ax.values())
        return ax[:1] == ("layers",)

    def walk(tree, ax, name):
        if isinstance(tree, dict) and stacked(ax):
            return {k: walk(v, ax[k], k) for k, v in tree.items()}
        if is_dtensor(tree) and stacked(ax):
            return LayerShards(tree)
        return _gather_tree(tree, name, ctx, grad_placements)
    return {k: walk(v, axes[k], k) for k, v in params.items()}


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

def mm(x: torch.Tensor, w, compute_dtype=torch.bfloat16,
       out_dtype=None) -> torch.Tensor:
    """x @ w, contracting x's last dim with w's first. ``w`` is a
    Q8Tensor or Q4Tensor (dispatched ``q8_matmul`` / ``q4_matmul``), a
    2-D tensor (dispatched ``fp16_matmul``) or a 3-D (k, heads,
    head_dim) tensor (``torch.matmul``). ``out_dtype`` (a 2-D weight's
    product; default ``compute_dtype``): the kernel's output dtype, f32
    for a row-parallel product's partial."""
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
                        out_dtype=out_dtype or compute_dtype)
    w = w.to(compute_dtype)
    if w.dim() == 3:   # (k, heads, head_dim)
        y = x.reshape(-1, k) @ w.reshape(k, -1)
        return y.reshape(*lead, *w.shape[1:])
    raise ValueError(f"unsupported weight rank {w.dim()}")


def mm_out(x: torch.Tensor, w, compute_dtype=torch.bfloat16,
           out_dtype=None) -> torch.Tensor:
    """(..., h, d) @ (h, d, n) -> (..., n) output projection. A Q4Tensor
    is packed along head_dim: (h, d // 2, n), and d % 32 == 0 keeps the
    flattened (h * d) contraction's 32-blocks inside one head.
    ``out_dtype`` (float weights): as ``mm``'s."""
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
                    out_dtype=out_dtype or compute_dtype)


# ----------------------------------------------------------------------------
# Norms, positions, embedding, head, MLP
# ----------------------------------------------------------------------------

def init_rmsnorm(d: int, device, axes: tuple = ("embed",)) -> torch.Tensor:
    return filled((d,), 1.0, device, axes)


def rmsnorm(w: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32, returned in x's dtype. Where
    ``w`` is this rank's ``model`` shard (``model_dim``: a mamba block's
    gated norm over its inner channels), x is the row's shard too: the
    mean square takes one f32 all-reduce of the partial sums of
    squares."""
    dt = x.dtype
    x = x.to(torch.float32)
    if model_dim(w) is not None:
        var = model_axis().all_reduce(x.square().sum(dim=-1, keepdim=True)) \
            / (x.shape[-1] * model_axis().size)
    else:
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
    Q4 table is widened to bf16, as the reference's ``embed`` does. A
    table split over ``model`` (its rows) is vocab-parallel: an id
    outside this rank's rows reads zeros, then one all-reduce, exact as
    each element has one nonzero term."""
    tbl = p["table"]
    if model_dim(tbl) is not None:
        n = tbl.shape[0]
        idx = tokens - vocab_offset(n)
        inside = ((idx >= 0) & (idx < n))[..., None]
        x = take_rows(tbl, idx.clamp(0, n - 1), compute_dtype)
        x = model_axis().all_reduce(torch.where(inside, x,
                                                torch.zeros_like(x)))
    elif isinstance(tbl, Q4Tensor):
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
    accumulated in f32 and never rounded to bf16. A head split over
    ``model`` along the vocabulary (the untied head's columns, or the
    tied table's rows) computes this rank's vocabulary columns, the
    padding mask offset by ``vocab_offset``; the logits come back as
    this rank's shard (``model_dim``: the last). An untied head split
    along d_model (``param_embed``) is row-parallel: this rank's f32
    partial of every column, summed over ``model``, the logits whole."""
    head_dim = None if head is None else model_dim(head)
    split = model_dim(p["table"]) is not None if head is None \
        else head_dim == 1
    if head_dim == 0:
        y = row_parallel_mm(model_chunk(x), head, _F32, _F32)
    elif head is not None:
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
    if split:
        off = vocab_offset(vp)
        pad_mask = torch.arange(off, off + vp, device=y.device) >= vocab
        return model_local(y - 1e9 * pad_mask.to(y.dtype), y.dim() - 1)
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
    """Plain two-layer MLP (Whisper); a ``gate`` weight makes it gated.
    Split over ``model`` along its columns (``ff``): ``up`` and ``gate``
    column-parallel, the activation on this rank's columns, ``down``
    row-parallel (its f32 partial, ``row_parallel_mm``). Split along
    d_model (``param_embed``): ``up`` and ``gate`` row-parallel on this
    rank's d_model slice of x, so the activation is whole on every
    rank, and ``down`` row-parallel on this rank's columns of it, a
    block of rows at a time (``by_rows``: the whole activation's f32
    temporaries of a prefill are not held at once)."""
    if model_dim(p["up"]) == 0:
        return by_rows(lambda t: _mlp_row_tp(p, t, act), x)
    up = constrain(mm(x, p["up"]), "batch", "q_seq", "ff")
    if "gate" in p:
        g = _act(act)(mm(x, p["gate"]))
        h = constrain(g, "batch", "q_seq", "ff") * up
    else:
        h = _act(act)(up)
    if model_dim(p["down"]) is not None:
        return row_parallel_mm(h, p["down"])
    return constrain(mm(h, p["down"]), "batch", "q_seq", "embed")


def _mlp_row_tp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """``mlp`` split along d_model (``param_embed``) on rows x."""
    xl = model_chunk(x)
    up = row_parallel_mm(xl, p["up"])
    h = _act(act)(row_parallel_mm(xl, p["gate"])) * up if "gate" in p \
        else _act(act)(up)
    return row_parallel_mm(model_chunk(h), p["down"])
