"""Step builders of the port (the JAX package's ``train/step.py``):
train (autograd + AdamW), prefill and decode, on one device.

The train forward runs under ``kernels.api.grad_safe_context``: the
Hopper kernels define no backward, so every dispatched op binds its
differentiable torch implementation there, as the reference binds XLA
under value_and_grad. Gradients come from ``torch.autograd.grad`` over
the parameter leaves; AdamW then updates the state in place under
``no_grad``. A step reads nothing back to the host: its metrics are 0-d
tensors on the state's device, and the loop's ``float(loss)`` is its
one synchronisation. ``n_micro > 1`` sums f32 gradients over equal
microbatches and divides, as the reference's ``lax.scan`` does.

With a ``mesh`` (a ``torch.distributed`` DeviceMesh with ``data`` and
``model`` axes, ``pod`` too for two pods) the state is DTensors placed
by ``state_shardings``: each rank stores its shard of every parameter
and moment, as the reference's pjit does. The forward takes the DTensor
tree (``models.layers.layer_params``): the leaves outside the layer
stacks (embeddings, head, final norms, the Whisper frontend, the
hybrid's shared block) are gathered whole once a step, each stacked
leaf is split into its layers once, and every stack loop gathers one
layer's slice at the start of the function that computes the layer
(``redistribute`` to replicated, FSDP-style) under the step's
``gather_context``. With ``remat`` (every full-size config) the slice
is freed after the layer's forward and gathered again when the backward
recomputes it, so a rank holds its shards, one layer gathered and the
unstacked leaves; without it autograd keeps each gathered weight a
product saves until the backward, and the step peaks at all its layers
gathered. Each rank runs the forward and backward on its rows of the
batch (sharded on dim 0 over the data axes); a layer's gradient goes
back through its gather as a partial sum over the data axes, which
DTensor reduce-scatters onto the parameter's placements, a layer at a
time, and AdamW then updates every local shard in place. The loss is
the token mean over the global batch (the ranks' NLL sums over their
summed token counts), so the step equals the single-device one up to
summation order. In training the model axis stores; it does not split
the compute (the constrain sites redistribute DTensor activations only,
and the gathered layers make none).

The meshed serving steps (``make_prefill_step`` / ``make_decode_step``
with a ``mesh``) take bf16 DTensor weights and keep the cache DTensors
in the placements of ``cache_shardings`` (batch over the data axes; KV
heads, or head_dim where the KV heads do not divide ``model``, heads,
ssm heads or the inner dim over ``model``) from prefill to the last
decode step. Each rank runs the rows its cache shard holds
(``layers.MeshRows``). The layers every family shares run on this
rank's ``model`` shard (Megatron-style tensor parallelism, the split the
reference's pjit makes): the attention on its heads (``wo``
row-parallel), the MLP on its columns (``down`` row-parallel), the
embedding vocab-parallel and the head on its vocabulary columns, the
MoE on its experts, the mamba and xLSTM blocks on their heads; where
the heads do not divide ``model`` (the reference's ``serve_row_tp``)
every product along d_model, row-parallel, with the Whisper frontend's
and decoder positions' columns (``layers.unit_form``,
``parallel.model_axis.MeshAxis``); a unit whose placements give no form
(a quantized cache's attention) is gathered a layer at a time, whole,
as above. The prefill keeps each layer's new cache as DTensors built
from its rows and shard, and a decode block reads its shard of one
layer's cache where its unit is split (else its rows gathered over the
model axis) and writes the new rows (or a state block's new state)
into the local shards in place (``layers.gather_cache_layer`` /
``write_cache_layer``).
Where the data axes do not divide the batch (``enforce_divisibility``
leaves it whole: long_500k's one lane), every rank runs every row, as
its cache holds them. The logits come back whole on every rank.

``make_compressed_train_step`` keeps the parameters replicated, takes
each rank's gradients on its rows and averages them over the data axes
with the int8 error-feedback all-reduce; its ``err`` leaves are
DTensors of ``(n_dp, *shape)``, one row a data rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.dtensor import is_dtensor, local
from repro_torch.kernels.api import grad_safe_context, use_context
from repro_torch.models.layers import (KV_PLANE_KEYS, MeshRows,
                                       gather_context, layer_params,
                                       model_axis, model_dim,
                                       sharded_argmax)
from repro_torch.models.model import Model, input_specs
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import (axes_size, compressed_psum,
                                              dp_axes, init_error_state,
                                              mesh_sum)
from repro_torch.parallel.model_axis import MeshAxis
from repro_torch.parallel.sharding import (Sharding, enforce_divisibility,
                                           fit, logical_context, place,
                                           spec_for, tree_shardings)
from repro_torch.platforms import resolve_device

TrainState = dict  # {"params": tree, "opt": {m, v, step}}

PREFILL_CACHE_PAD = 16   # decode headroom


def prefill_cache_len(seq: int) -> int:
    return seq + PREFILL_CACHE_PAD


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def nll_sum(logits: torch.Tensor, targets: torch.Tensor,
            ignore_id: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, counted tokens) in f32 over the positions whose
    target is not ``ignore_id``."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.clamp(targets, min=0).to(torch.int64)
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (targets != ignore_id).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Token-mean CE. logits: (B, S, V) any float; targets: (B, S) int.
    In f32; positions whose target is ``ignore_id`` carry no loss."""
    total, count = nll_sum(logits, targets, ignore_id)
    return total / torch.clamp(count, min=1.0)


def _logits_targets(model: Model, params, batch):
    # this forward sits under autograd; the kernels define no backward,
    # so the dispatch binds the differentiable torch implementations
    with use_context(grad_safe_context()):
        logits, _ = model.forward(params, batch, mode="train")
    tgt = batch["targets"]
    # VLM: logits cover img-prefix + text; targets already full-seq length.
    if logits.shape[1] != tgt.shape[1]:
        tgt = tgt[:, :logits.shape[1]]
    return logits, tgt


def _loss_fn(model: Model, params, batch) -> tuple[torch.Tensor, dict]:
    loss = cross_entropy(*_logits_targets(model, params, batch))
    return loss, {"loss": loss}


# ----------------------------------------------------------------------------
# Train step
# ----------------------------------------------------------------------------

def init_train_state(model: Model, generator: torch.Generator,
                     device=None) -> TrainState:
    """f32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``) and a fresh AdamW state."""
    params = model.init_values(generator, resolve_device(device))
    return {"params": params, "opt": adamw.init_state(params)}


def _on_device(batch: dict, device) -> dict:
    """The batch as tensors on ``device`` (numpy arrays are copied)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(model: Model, params, batch) -> tuple:
    """(loss, gradients shaped as ``params``) of one batch: the
    reference's ``value_and_grad(_loss_fn)``. ``params`` are not
    modified; the gradients are in each leaf's dtype."""
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = _loss_fn(model, live, batch)
        grads = iter(torch.autograd.grad(loss, list(adamw.leaves(live)),
                                         allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), adamw.tree_map(lambda _: next(grads), live)


def state_axes(model: Model) -> dict:
    """Logical-axes tree matching init_train_state's structure."""
    axes = model.param_axes()
    return {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


def state_shapes(model: Model) -> dict:
    """init_train_state's tree as ``meta`` tensors (no storage)."""
    shapes = model.param_shapes()
    moments = adamw.tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
        shapes)
    return {"params": shapes,
            "opt": {"m": moments,
                    "v": adamw.tree_map(lambda p: p, moments),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def state_shardings(model: Model, mesh, rules: dict) -> dict:
    return enforce_divisibility(
        tree_shardings(state_axes(model), mesh, rules), state_shapes(model))


def _batch_spec(ndim: int, rules: dict) -> tuple:
    if ndim == 0:
        return ()
    return spec_for(("batch",) + (None,) * (ndim - 1), rules)


def batch_shardings(cfg: ArchConfig, shape: str, mesh, rules: dict) -> dict:
    """Shardings of the input batch of an (arch, shape) cell."""
    specs = input_specs(cfg, shape)
    out = {k: Sharding(mesh, _batch_spec(v.ndim, rules))
           for k, v in specs.items()}
    return enforce_divisibility(out, specs)


def shard_batch(batch: dict, mesh, device=None) -> dict:
    """The global ``batch`` (numpy arrays or tensors, whole on every
    rank) as DTensors sharded on dim 0 over the data axes."""
    axes = dp_axes(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        spec = (axes or None,) + (None,) * (t.ndim - 1) if t.ndim else ()
        out[k] = place(t, Sharding(mesh, spec))
    return out


def _dp_index(mesh) -> tuple[int, int]:
    """(this rank's index among the data ranks, their number)."""
    idx, n = 0, 1
    coords = mesh.get_coordinate()
    for a in dp_axes(mesh):
        i = mesh.mesh_dim_names.index(a)
        idx, n = idx * mesh.size(i) + coords[i], n * mesh.size(i)
    return idx, n


def local_rows(batch: dict, mesh, device) -> dict:
    """This rank's rows of ``batch``: a DTensor's local shard, else the
    data rank's block of dim 0 of the global array."""
    idx, n = _dp_index(mesh)
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            out[k] = v.to_local()
            continue
        t = torch.as_tensor(v, device=device)
        if t.ndim and n > 1:
            if t.shape[0] % n:
                raise ValueError(f"batch {k!r} of {t.shape[0]} rows does not "
                                 f"split over {n} data ranks")
            t = t.chunk(n, dim=0)[idx]
        out[k] = t
    return out


def sharded_value_and_grad(model: Model, params, batch: dict, mesh,
                           param_axes: dict) -> tuple:
    """(global-batch loss, gradients placed as ``params``) of one step:
    ``params`` are DTensors, gathered a layer at a time
    (``layers.layer_params``; ``param_axes``: ``model.param_axes()``,
    which a step maker computes once), ``batch`` this rank's rows. The
    loss this rank differentiates is its NLL sum over the global token
    count, so the gradients' sum over the data ranks is the global
    mean's."""
    from torch.distributed.tensor import Partial, Replicate
    axes = dp_axes(mesh)
    grad_pl = [Partial() if n in axes else Replicate()
               for n in mesh.mesh_dim_names]
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad(), gather_context(grad_pl):
        tree = layer_params(live, param_axes, grad_pl)
        total, count = nll_sum(*_logits_targets(model, tree, batch))
        del tree
        count = mesh_sum(count.detach(), mesh, axes)
        loss = total / torch.clamp(count, min=1.0)
        grads = iter(torch.autograd.grad(loss, list(adamw.leaves(live)),
                                         allow_unused=True,
                                         materialize_grads=True))
    return (mesh_sum(loss.detach(), mesh, axes),
            adamw.tree_map(lambda _: next(grads), live))


def _first_device(tree) -> torch.device:
    x = next(adamw.leaves(tree))
    return local(x).device


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *,
                    mesh=None, rules: Optional[dict] = None,
                    n_micro: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): the state
    updated in place, metrics ``loss``, ``grad_norm`` and ``lr`` (0-d
    tensors on the state's device). ``n_micro > 1`` accumulates f32
    gradients over microbatches (the batch must divide evenly). A batch
    of numpy arrays is moved to the parameters' device. With ``mesh``
    the state is DTensors (``state_shardings``) and the batch the global
    one (numpy or tensors, each rank takes its rows) or DTensors
    (``shard_batch``); the body runs under ``logical_context``."""

    axes = None if mesh is None else model.param_axes()

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(model, params, batch)
        return sharded_value_and_grad(model, params, batch, mesh, axes)

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        device = _first_device(params)
        batch = (_on_device(batch, device) if mesh is None
                 else local_rows(batch, mesh, device))
        if n_micro == 1:
            loss, grads = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            grads, losses = None, []
            for i in range(n_micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = grads_of(params, part)
                losses.append(l)
                if grads is None:
                    grads = [x.to(torch.float32) for x in adamw.leaves(g)]
                else:
                    for acc, x in zip(grads, adamw.leaves(g)):
                        acc.add_(x)
            mean = iter([g / n_micro for g in grads])
            grads = adamw.tree_map(lambda _: next(mean), params)
            loss = torch.stack(losses).mean()
        _, opt, metrics = adamw.apply_updates(params, grads, state["opt"],
                                              opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    if mesh is None:
        return train_step

    def train_step_meshed(state, batch):
        with logical_context(mesh, rules):
            return train_step(state, batch)

    return train_step_meshed


def make_compressed_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                               mesh) -> Callable:
    """DP-compressed variant: each rank's gradients on its rows are
    averaged over the data axes with the int8 error-feedback all-reduce
    (``parallel.collectives.compressed_psum``) instead of an exact f32
    one. The parameters and AdamW state are replicated (plain tensors,
    equal on every rank); ``state["err"]`` holds DTensors of ``(n_dp,
    *shape)`` f32 residuals, sharded on dim 0 over the data axes
    (``init_compressed_state``). The loss is the ranks' mean. Only the
    data axes are mapped, as in the reference: a model axis repeats the
    work."""
    axes = dp_axes(mesh)

    def step(state, batch):
        params = state["params"]
        device = _first_device(params)
        loss, grads = value_and_grad(model, params,
                                     local_rows(batch, mesh, device))
        err = state["err"]
        e_local = [e.to_local()[0] for e in adamw.leaves(err)]
        mean, new_err = compressed_psum(list(adamw.leaves(grads)), e_local,
                                        mesh, axes)
        for e, ne in zip(e_local, new_err):
            e.copy_(ne)
        it = iter(mean)
        grads = adamw.tree_map(lambda _: next(it), params)
        loss = mesh_sum(loss, mesh, axes) / axes_size(mesh, axes)
        _, opt, metrics = adamw.apply_updates(params, grads, state["opt"],
                                              opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt, "err": err}, metrics

    return step


def init_compressed_state(model: Model, generator: torch.Generator, mesh,
                          device=None) -> TrainState:
    """Train state plus the per-data-rank error-feedback residuals:
    zeros of ``(n_dp, *shape)`` for each parameter, placed one row a
    data rank."""
    state = init_train_state(model, generator, device)
    state["err"] = init_error_state(state["params"], mesh)
    return state


# ----------------------------------------------------------------------------
# Serving steps (prefill / decode)
# ----------------------------------------------------------------------------

def serve_rows(batch: dict, rows: MeshRows, device) -> dict:
    """The rows ``rows`` runs of a meshed serving step's inputs (global
    numpy arrays or tensors, or DTensors such as ``shard_batch`` and
    ``batch_shardings`` place them): a DTensor's local shard where it
    holds them, else this rank's block of dim 0 (every row where the
    data axes do not divide the batch). 0-d inputs (a scalar ``pos``) as
    tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            if v.ndim and rows.own_rows(v.placements):
                out[k] = v.to_local()
                continue
            v = v.full_tensor()
        t = torch.as_tensor(v, device=device)
        out[k] = rows.take(t) if t.ndim else t
    return out


def _mesh_rows(mesh, n: int) -> MeshRows:
    """The rows of a global batch of ``n`` that this rank runs."""
    return MeshRows(mesh, dp_axes(mesh), n)


def _model_axis(mesh) -> Optional[MeshAxis]:
    """The split's model axis of ``mesh`` (None without a ``model`` axis
    of more than one rank: nothing is split)."""
    names = mesh.mesh_dim_names
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return MeshAxis(mesh)


def _placed_rows(tree, rows: MeshRows, rules: dict, keys: list):
    """A prefill layer's new cache subtree, this rank's rows at full
    width (or, where a split attention made it, at its ``model`` shard:
    ``layers.model_dim``), as DTensors in the placements
    ``cache_shardings`` gives the layer (``MeshRows.place``: built from
    this rank's block)."""
    if isinstance(tree, dict):
        return {k: _placed_rows(v, rows, rules, keys + [str(k)])
                for k, v in tree.items()}
    sh = _cache_leaf_sharding(keys, rows.global_shape(tree), rows.mesh,
                              rules)
    return rows.place(tree, sh.placements)


class _Planes:
    """A prefill template's KV plane: the shape and dtype by which a
    prefill pads and casts a layer's new K/V (all that
    ``attention._write_prefill_cache`` reads of it), indexed by layer as
    the stacked leaf is. No storage."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def __getitem__(self, i) -> "_Planes":
        return _Planes(self.shape[1:], self.dtype)


def prefill_template(model: Model, batch: int, length: int, device) -> dict:
    """The cache a prefill is handed to name its length and dtypes: each
    KV plane a ``_Planes`` (the prefill makes new planes; zeros of the
    old would take 2 x 36 x 134 MB at a qwen3-4b prefill_32k rank of two
    rows), every other leaf (the MoE routing counts, a recurrent block's
    state, which the prefill reads) zeros on ``device``. The tree's
    shapes come from ``model.cache_specs`` made outside any tracing
    mode, so a dry-run's trace holds no op on them."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        specs = model.cache_specs(batch, length)

    def walk(t, planes):
        if isinstance(t, dict):
            inner = set(t) in KV_PLANE_KEYS
            return {k: walk(v, inner) for k, v in t.items()}
        if planes:
            return _Planes(t.shape, t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return walk(specs, False)


def _last(logits: torch.Tensor, sample: bool) -> torch.Tensor:
    """The last position's logits (B, V) of ``logits`` (B, S, V), or its
    greedy ids with ``sample``: where the head's columns are split over
    ``model`` (``model_dim``), gathered over ``model`` once, or their ids
    by ``sharded_argmax``."""
    split = model_dim(logits) is not None
    last = logits[:, -1]
    if not split:
        return torch.argmax(last, dim=-1).to(torch.int32) if sample else last
    return sharded_argmax(last) if sample \
        else model_axis().all_gather(last, dim=-1)


def _quantized(tree) -> bool:
    """Whether a cache tree holds quantized KV planes."""
    if isinstance(tree, dict):
        if set(tree) in KV_PLANE_KEYS:
            return set(tree) != {"k", "v"}
        return any(_quantized(v) for v in tree.values())
    return False


def make_prefill_step(model: Model, *, mesh=None,
                      rules: Optional[dict] = None) -> Callable:
    """prefill_step(params, batch) -> (last_logits, cache), the cache
    ``prefill_cache_len(seq)`` long, the head run on the last position
    alone (``Model.forward(last_only=True)``; nothing reads the rest),
    the cache named by ``prefill_template``. With ``mesh``: ``params``
    (and the batch) may be DTensors; each rank runs its rows of the batch
    (``serve_rows``: its block over the data axes, every row where they
    do not divide it) under ``logical_context`` and ``no_grad``,
    gathering the parameters a layer at a time (``layers.layer_params``)
    but for the layers every family shares, which it runs on its
    ``model`` shards (``layers.unit_form``: the attention heads, the
    MLP's columns, the vocabulary, the experts, the mamba and xLSTM
    heads, or d_model where the heads do not divide ``model``), and
    keeps each layer's new cache as
    DTensors in the placements of ``cache_shardings`` as the layer makes
    it, built from this rank's rows and shard (``MeshRows.place``); the
    last position's logits come back whole on every rank (one all-gather
    over ``model``, one over the data axes)."""

    def run(params, batch):
        tokens = batch["tokens"]
        b, seq = tokens.shape
        cache = prefill_template(model, b, prefill_cache_len(seq),
                                 tokens.device)
        return model.forward(params, batch, mode="prefill", cache=cache,
                             last_only=True)

    def prefill(params, batch):
        logits, cache = run(params, batch)
        return _last(logits, False), cache

    if mesh is None:
        return prefill
    axes = model.param_axes()

    def prefill_meshed(params, batch):
        rows = _mesh_rows(mesh, batch["tokens"].shape[0])
        batch = serve_rows(batch, rows, _first_device(params))
        with logical_context(mesh, rules), torch.no_grad(), \
                gather_context(place_cache=lambda t: _placed_rows(
                    t, rows, rules, []), model=_model_axis(mesh)):
            logits, cache = run(layer_params(params, axes), batch)
            return rows.all_rows(_last(logits, False)), cache

    return prefill_meshed


def make_decode_step(model: Model, *, mesh=None,
                     rules: Optional[dict] = None,
                     sample: bool = False) -> Callable:
    """decode_step(params, cache, tokens, pos) -> (next_tokens|logits,
    cache). ``tokens``: (B, 1); ``pos``: the position, a scalar or (B,).
    With ``mesh``: ``params`` and ``cache`` DTensors (``cache_shardings``,
    as the meshed prefill returns it); each rank decodes the rows its
    cache shard holds (``serve_rows``; every row where the data axes do
    not divide the batch) under ``logical_context`` and ``no_grad``, the
    parameters gathered a layer at a time but for the split layers, as
    the meshed prefill, and each block's cache too: this rank's rows of
    the layer, gathered over the model axis where the block's attention
    is whole (a split one reads its shard: its KV heads, or head_dim;
    a split mamba or xLSTM block its state's heads),
    read, and its new rows written into the local shards
    (``layers.gather_cache_layer`` / ``write_cache_layer``). A quantized
    cache keeps the attention whole. It returns the same cache tree,
    written in place, and the logits (or ids: ``layers.sharded_argmax``)
    whole on every rank (one all-gather over ``model``, one over the
    data axes)."""

    def decode(params, cache, tokens, pos):
        logits, new_cache = model.forward(
            params, {"tokens": tokens}, mode="decode", cache=cache, pos=pos)
        return _last(logits, sample), new_cache

    if mesh is None:
        return decode
    axes = model.param_axes()

    def decode_meshed(params, cache, tokens, pos):
        rows = _mesh_rows(mesh, tokens.shape[0])
        got = serve_rows({"tokens": tokens, "pos": pos}, rows,
                         _first_device(params))
        with logical_context(mesh, rules), torch.no_grad(), \
                gather_context(rows=rows, model=_model_axis(mesh),
                               split_attention=not _quantized(cache)):
            out, _ = decode(layer_params(params, axes), cache,
                            got["tokens"], got["pos"])
            return rows.all_rows(out), cache

    return decode_meshed


# ----------------------------------------------------------------------------
# Cache sharding (decode cells)
# ----------------------------------------------------------------------------

# (family, leaf) -> logical axes; family = the enclosing cache-kind key
_CACHE_AXES = {
    ("kv", "k"): ("batch", "cache_seq", "kv_heads", "head_dim"),
    ("kv", "v"): ("batch", "cache_seq", "kv_heads", "head_dim"),
    ("ssm", "conv"): ("batch", None, "inner"),
    ("ssm", "h"): ("batch", "ssm_heads", None, None),
    ("mstate", "C"): ("batch", "heads", None, None),
    ("mstate", "n"): ("batch", "heads", None),
    ("mstate", "m"): ("batch", "heads"),
    ("sstate", "c"): ("batch", "heads", None),
    ("sstate", "n"): ("batch", "heads", None),
    ("sstate", "h"): ("batch", "heads", None),
    ("sstate", "m"): ("batch", "heads"),
}
_FAMILIES = {"kv", "ssm", "mstate", "sstate", "self", "cross"}


def _cache_leaf_sharding(keys: list, shape: tuple, mesh,
                         rules: dict) -> Sharding:
    """The sharding of the cache leaf at ``keys`` (its path) of
    ``shape``: the family's logical axes on its last dims (leading
    stacked-layer dims unsharded), dropped where the mesh does not
    divide a dim."""
    fam = next((k for k in reversed(keys[:-1]) if k in _FAMILIES), None)
    if fam in ("self", "cross"):   # encdec caches hold raw k/v dicts
        fam = "kv"
    axes = _CACHE_AXES.get((fam, keys[-1]))
    full = ((None,) * len(shape) if axes is None
            else (None,) * (len(shape) - len(axes)) + axes)
    return fit(Sharding(mesh, spec_for(full, rules)), shape)


def _cache_walk(tree, mesh, rules: dict, keys: list):
    if isinstance(tree, dict):
        return {k: _cache_walk(v, mesh, rules, keys + [str(k)])
                for k, v in tree.items()}
    return _cache_leaf_sharding(keys, tuple(tree.shape), mesh, rules)


def cache_shardings(model: Model, batch: int, max_len: int, mesh,
                    rules: dict, enc_len: int = 1500) -> dict:
    """Shardings of the KV / state cache tree. Leading stacked-layer
    dims (segments) stay unsharded."""
    return _cache_walk(model.cache_specs(batch, max_len, enc_len), mesh,
                       rules, [])
