"""AdamW with global-norm clipping and a warmup-cosine schedule (the JAX
package's ``optim/adamw.py``), over the port's nested-dict parameter
trees.

The arithmetic is the reference's: f32 moments, bias correction from an
int32 step, the gradient scaled by ``min(1, clip_norm / (norm + 1e-9))``,
decay on leaves of two or more dimensions only, the result cast back to
the parameter's dtype. ``apply_updates`` writes ``params``, ``m``, ``v``
and ``step`` in place under ``torch.no_grad()`` (the counterpart of the
reference launcher's ``donate_argnums=0``: the state is never held twice
on the card) and returns them. ``step``, ``lr`` and ``grad_norm`` stay
0-d tensors on the state's device, so an update reads nothing back to
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order (the order
    ``jax.tree.leaves`` walks a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree: Any) -> Any:
    """``fn`` of every tensor of a nested dict, the dict rebuilt; the
    leaves are visited in ``leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d int tensor): linear warmup to
    ``lr``, then a cosine down to ``min_lr_ratio * lr``; f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: Any) -> dict:
    """``{"m", "v"}``: f32 zeros shaped as ``params``; ``step``: a 0-d
    int32 zero on the parameters' device."""
    device = next(leaves(params)).device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    total = None
    for x in leaves(tree):
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict,
                  cfg: AdamWConfig) -> tuple[Any, dict, dict]:
    """One AdamW step: writes ``params``, ``state["m"]``, ``state["v"]``
    and ``state["step"]`` in place and returns ``(params, state, {"grad_norm", "lr"})``."""
    step = state["step"]
    step.add_(1)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g) * (1 - cfg.b2))
        denom = torch.sqrt(v / b2c).add_(cfg.eps)
        delta = (m / b1c).div_(denom)
        if p.dim() >= 2:      # decay matrices only (norms, biases excluded)
            delta.add_(p.to(torch.float32) * cfg.weight_decay)
        new = p.to(torch.float32) - lr * delta
        p.copy_(new)
    return params, state, {"grad_norm": gnorm, "lr": lr}
