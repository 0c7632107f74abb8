"""The ``model`` axis of a meshed serving step as its split layers see it
(Megatron-style tensor parallelism, the split the reference's pjit makes
under ``rules_for(cfg, mesh, "serve")``): the axis's size, this rank's
coordinate along it, and the three collectives a split layer makes over
it.

* ``all_reduce``: the sum of every rank's tensor (a row-parallel
  product's f32 partials, a vocab-parallel embedding's rows);
* ``all_gather``: every rank's tensor, concatenated along a dim in rank
  order (the head's vocabulary columns, the queries of every head);
* ``all_to_all``: chunk ``j`` of a dim to rank ``j``, the received
  chunks concatenated along another dim in rank order (an attention
  output from a split of head_dim to a split of the heads).

``MeshAxis`` runs them over one dim of a DeviceMesh as
``_c10d_functional`` ops, which the dry-run's tracer counts as
collectives. ``ThreadAxis`` runs them between the threads of
``run_shards``, one shard a thread in one process: a test, or one card,
evaluates a split layer shard by shard and reads the sums it made
(``reduced``). Given ``forms``, such a run splits whole plain weights
too, each unit in the form named (``models.layers.unit_form``): a whole
model's steps then run shard by shard.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch


class ModelAxis:
    """The model axis: ``size`` ranks, this one at ``rank``. ``forms``:
    None where the placements of DTensor weights decide each unit's
    form, else {unit: form} for whole plain weights."""

    forms = None

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        raise NotImplementedError


def _c10d():
    return torch.ops._c10d_functional


class MeshAxis(ModelAxis):
    """The model axis ``name`` of ``mesh``, over its process group."""

    def __init__(self, mesh, name: str = "model"):
        dim = mesh.mesh_dim_names.index(name)
        super().__init__(mesh.size(dim), mesh.get_coordinate()[dim])
        self.group = mesh.get_group(dim).group_name

    def all_reduce(self, t):
        c = _c10d()
        return c.wait_tensor(c.all_reduce(t.contiguous(), "sum", self.group))

    def all_gather(self, t, dim):
        c = _c10d()
        out = c.wait_tensor(c.all_gather_into_tensor(t.contiguous(),
                                                     self.size, self.group))
        return out if dim == 0 else torch.cat(out.chunk(self.size), dim)

    def all_to_all(self, t, split_dim, cat_dim):
        c = _c10d()
        x = t.unflatten(split_dim, (self.size, -1)).movedim(split_dim, 0)
        splits = [x.shape[0] // self.size] * self.size
        y = c.wait_tensor(c.all_to_all_single(x.contiguous(), splits,
                                              splits, self.group))
        return y.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)


class _Exchange:
    """What the threads of one ``run_shards`` share: a slot a rank and a
    barrier."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class ThreadAxis(ModelAxis):
    """Rank ``rank`` of ``run_shards``' threads. Each collective puts this
    rank's tensor in its slot, waits for every rank, reads all slots and
    waits again (so no slot is overwritten before every rank read it);
    the sum adds the ranks' tensors in rank order, the same bits on every
    rank. ``reduced`` keeps every sum made, in order."""

    def __init__(self, size: int, rank: int, shared: _Exchange,
                 forms=None):
        super().__init__(size, rank)
        self.shared, self.forms = shared, forms
        self.reduced: list = []

    def _exchange(self, t: torch.Tensor) -> list:
        sh = self.shared
        sh.slots[self.rank] = t
        sh.barrier.wait()
        got = list(sh.slots)
        sh.barrier.wait()
        return got

    def all_reduce(self, t):
        parts = self._exchange(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        self.reduced.append(out)
        return out

    def all_gather(self, t, dim):
        return torch.cat(self._exchange(t), dim)

    def all_to_all(self, t, split_dim, cat_dim):
        parts = self._exchange(t)
        return torch.cat([p.chunk(self.size, split_dim)[self.rank]
                          for p in parts], cat_dim)


def run_shards(size: int, fn: Callable, forms=None) -> list:
    """``[fn(axis) for each rank]``, each call in a thread of its own
    with its ``ThreadAxis`` (of ``forms``), all at once (their
    collectives meet). A call that raises breaks the barrier, so the
    others stop too; the first error is raised."""
    shared = _Exchange(size)
    out, errors = [None] * size, []

    def one(rank):
        try:
            out[rank] = fn(ThreadAxis(size, rank, shared, forms))
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return out
