"""GPipe-style pipeline parallelism over the ``pipe`` group's
point-to-point sends (the JAX package's ``parallel/pipeline.py``).

The layer stack is cut into ``n_stages`` contiguous groups; stage *i*'s
parameters live on pipe-rank *i*. A forward pass streams ``n_micro``
microbatches around a ring: at tick *t* rank 0 injects microbatch *t*
while rank *s* works on microbatch *t-s*, the GPipe schedule with
``n_stages - 1`` bubble ticks; every rank computes every tick, and each
tick ends with every rank sending its result to the next one and
receiving the previous one's. The last stage banks the valid
microbatches and its outputs are broadcast to every rank at the end.

Differentiable end to end: each hop is an ``autograd.Function`` whose
backward sends the gradient the other way around the ring, so every
rank runs the same exchanges in reverse tick order. The broadcast output
is replicated; its gradient is taken from the last stage's copy, so
every rank must compute the same loss from it (as a loss of replicated
values is).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L//n_stages, ...)."""
    def re(x):
        l = x.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return x.reshape(n_stages, l // n_stages, *x.shape[1:])
    if isinstance(stacked_params, dict):
        return {k: split_stages(v, n_stages)
                for k, v in stacked_params.items()}
    return re(stacked_params)


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _stage_apply(layer_fn: Callable, stage_params, x):
    """Run this stage's layer group in order."""
    n = stage_params.shape[0] if not isinstance(stage_params, dict) else \
        next(iter(_leaves(stage_params))).shape[0]
    for i in range(n):
        x = layer_fn(_take(stage_params, i), x)
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """What rank ``r - shift`` sent: every rank sends ``x`` to ``r +
    shift`` and receives from ``r - shift`` (mod the group's size)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Hop(torch.autograd.Function):
    """One forward hop of the ring; the gradient goes back one hop."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1), None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (a sum in which the others
    add zeros); the gradient returns to the last stage's copy only."""

    @staticmethod
    def forward(ctx, x, group, last: bool):
        ctx.last = last
        y = x.clone() if last else torch.zeros_like(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def pipeline_forward(layer_fn: Callable, stage_params, mbs: torch.Tensor,
                     *, group, n_stages: int) -> torch.Tensor:
    """``stage_params``: this rank's (L/S, ...) layer group; ``mbs`` the
    full (n_micro, mb, ...) input (equal on every rank). Returns the
    (n_micro, mb, ...) outputs on every rank."""
    stage = dist.get_rank(group)
    last = stage == n_stages - 1
    n_micro = mbs.shape[0]
    ticks = n_micro + n_stages - 1
    first = torch.tensor(stage == 0, device=mbs.device)
    state = torch.zeros_like(mbs[0])
    banked = []
    for t in range(ticks):
        # rank 0 injects microbatch t (clamped; bubble ticks discarded);
        # ``where`` keeps the received state in the graph on rank 0 too,
        # so every rank runs every hop's backward
        x_in = torch.where(first, mbs[min(t, n_micro - 1)], state)
        y = _stage_apply(layer_fn, stage_params, x_in)
        if t >= n_stages - 1:
            banked.append(y)     # valid on the last stage
        state = _Hop.apply(y, group)
    return _FromLast.apply(torch.stack(banked), group, last)


def make_pipelined_fn(layer_fn: Callable, mesh, n_stages: int,
                      axis: str = "pipe") -> Callable:
    """Returns f(stacked_params, mbs) -> outputs over the ``axis`` group
    of ``mesh``: stacked_params (L, ...) whole on every rank (each rank
    runs its stage's slice, so its gradient is non-zero there only);
    mbs (n_micro, mb, ...)."""
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    if size != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis!r} axis of "
                         f"{size} ranks")

    def f(stacked_params, mbs):
        staged = split_stages(stacked_params, n_stages)
        mine = _take(staged, dist.get_rank(group))
        return pipeline_forward(layer_fn, mine, mbs, group=group,
                                n_stages=n_stages)

    return f
