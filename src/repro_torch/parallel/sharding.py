"""Logical-axis sharding rules (the JAX package's
``parallel/sharding.py``) over a ``torch.distributed`` DeviceMesh.

Models name the logical axes of their parameters (``Model.param_axes``)
and activations; ``rules_for(cfg, mesh, mode)`` binds those names to mesh
axes per architecture, falling back where a dimension does not divide
the mesh axis:

* ``heads % tp != 0``  -> context parallelism: q-seq over 'model'.
* ``kv_heads % tp != 0`` -> KV replicated over 'model'.
* ``experts % tp != 0``  -> per-expert d_ff over 'model' instead of EP.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name
or a tuple of them (the reference's ``PartitionSpec``, entry for entry).
A ``Sharding`` pairs a spec with a mesh; its ``placements`` are the
DTensor ones: for each mesh dim, ``Shard(d)`` where that mesh axis sits
at tensor dim ``d``, else ``Replicate()``. A dim over ``("pod",
"data")`` is two ``Shard(d)`` placements, split pod-major as the
reference's ``NamedSharding`` splits it. ``enforce_divisibility`` drops
the entries a dim does not divide, as the reference must for pjit; a
DTensor would take an uneven shard, the port does not.

Inside model code ``constrain(x, *logical_axes)`` redistributes a
DTensor activation to the spec's placements while a ``logical_context``
is active; a plain tensor, or no context, returns ``x`` untouched (no
copy, no collective).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.dtensor import is_dtensor

_TLS = threading.local()


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (its ``mesh_dim_names``) or of
    anything with a ``.shape`` dict, in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_size(shape: dict, name: str) -> int:
    return shape.get(name, 1)


def rules_for(cfg: ArchConfig, mesh, mode: str = "train") -> dict:
    """Map logical axis names -> mesh axis (str / tuple / None). Reads
    only the mesh's axis sizes. The reference's ``REPRO_BASELINE``
    branches take their default (off)."""
    shape = mesh_shape(mesh)
    tp = _axis_size(shape, "model")
    dp_axes = tuple(a for a in ("pod", "data") if a in shape)

    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    hd_ok = cfg.head_dim % tp == 0
    ep_ok = cfg.is_moe and cfg.n_experts % tp == 0
    fsdp = mode == "train"  # shard params' embed dim over data for training
    # serve-mode KV cache when kv heads don't divide TP: shard head_dim
    # (writes stay local) rather than the sequence
    kv_on_hd = mode != "train" and not kv_ok and hd_ok
    # serve mode with heads % tp != 0: shard the attention matrices'
    # d_model dim over 'model' instead (Megatron row/col-parallel)
    serve_row_tp = mode != "train" and not heads_ok

    return {
        "batch": dp_axes or None,
        "embed": None,            # activation d_model stays unsharded
        "param_embed": ("data" if (fsdp and "data" in shape)
                        else "model" if serve_row_tp else None),
        "ff": "model",
        "vocab": "model",
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "head_dim": "model" if kv_on_hd else None,
        "q_seq": None if heads_ok else "model",      # context parallelism
        "kv_seq": None,
        "cache_seq": None,
        "experts": "model" if ep_ok else None,
        "expert_ff": None if ep_ok else "model",
        "layers": None,
        "inner": "model",         # ssm/xlstm inner expansion dim
        "ssm_heads": "model" if (cfg.ssm_state and
                                 _ssm_heads(cfg) % tp == 0) else None,
        "state": None,
        "conv": None,
        "seq": None,
    }


def _ssm_heads(cfg: ArchConfig) -> int:
    return (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim


def spec_for(axes: tuple, rules: dict) -> tuple:
    """The spec of a tensor whose dims carry ``axes``; a mesh axis binds
    at most once a spec (a later dim asking for it stays unsharded)."""
    parts = []
    used = set()
    for a in axes:
        r = rules.get(a) if a is not None else None
        if r is None:
            parts.append(None)
            continue
        key = tuple(r) if isinstance(r, tuple) else (r,)
        if any(k in used for k in key):
            parts.append(None)
            continue
        used.update(key)
        # a one-axis tuple is that axis, as PartitionSpec writes it
        parts.append(key[0] if len(key) == 1 else r)
    return tuple(parts)


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_shape(self.mesh):
            dim = next((d for d, e in enumerate(self.spec)
                        if e is not None and name in _names(e)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(axes_tree, rules: dict):
    return _map(lambda axes: spec_for(axes, rules), axes_tree)


def tree_shardings(axes_tree, mesh, rules: dict):
    return _map(lambda spec: Sharding(mesh, spec),
                tree_specs(axes_tree, rules))


def _divisible(spec: tuple, shape, mesh) -> tuple:
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    parts = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            parts.append(None)
            continue
        size = 1
        for n in _names(entry):
            size *= sizes[n]
        parts.append(entry if dim % size == 0 else None)
    return tuple(parts)


def fit(sharding: Sharding, shape: tuple) -> Sharding:
    """``sharding`` with the entries dropped that the mesh axes do not
    divide on a tensor of ``shape`` (no tensor is made)."""
    return Sharding(sharding.mesh, _divisible(sharding.spec, tuple(shape),
                                              sharding.mesh))


def enforce_divisibility(sharding_tree, shape_tree):
    """Drop sharding on dims the mesh axes do not divide (whisper's
    1500-frame cross cache, batch-1 decode, ...); ``shape_tree`` holds
    anything with a ``.shape`` (meta tensors, specs, tensors)."""
    def fix(sh, leaf):
        if not isinstance(sh, Sharding) or not hasattr(leaf, "shape"):
            return sh
        return fit(sh, leaf.shape)
    return _map(fix, sharding_tree, shape_tree)


@contextlib.contextmanager
def logical_context(mesh, rules: dict):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the placements of ``axes`` under the active
    ``logical_context`` (dims the mesh axes do not divide stay whole);
    ``x`` itself without a context or when it is not a DTensor."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    spec = _divisible(spec_for(tuple(axes), rules), tuple(x.shape), mesh)
    want = Sharding(mesh, spec).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def place(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The DTensor of the global tensor ``t`` (whole on every rank) placed
    by ``sharding``: each rank keeps the chunk its mesh coordinates
    select, pod-major where a dim is split over several mesh axes. No
    collective. A chunk smaller than ``t`` is copied into storage of its
    own (``t`` can then be freed); a whole one is ``t`` itself."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    placements = sharding.placements
    coords = mesh.get_coordinate()
    local = t
    for i, pl in enumerate(placements):
        if pl.is_shard():
            local = local.chunk(mesh.size(i), dim=pl.dim)[coords[i]]
    local = (local.clone(memory_format=torch.contiguous_format)
             if local.numel() < t.numel() else local.contiguous())
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def place_tree(tree, shardings):
    """``place`` over matching trees; a leaf whose sharding is None stays
    a plain tensor."""
    return _map(lambda t, sh: t if sh is None else place(t, sh), tree,
                shardings)


def sharding_of(x) -> Optional[Sharding]:
    """The ``Sharding`` a DTensor is placed by (None for a plain
    tensor)."""
    if not is_dtensor(x):
        return None
    names = x.device_mesh.mesh_dim_names
    spec = [None] * x.ndim
    for name, pl in zip(names, x.placements):
        if pl.is_shard():
            prev = spec[pl.dim]
            spec[pl.dim] = name if prev is None else _names(prev) + (name,)
    return Sharding(x.device_mesh, tuple(spec))
