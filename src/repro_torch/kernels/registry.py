"""Kernel-op registry and the analytic footprint model behind the
ACCEL/HOST decision.

A ``KernelOp`` bundles an op's ``spec`` builder (its call's operands ->
``KernelSpec``), its backends and their order on each side of the
decision. The port's backends are ``"cuda"`` (the hand-written Hopper
kernel, the ACCEL side) and ``"torch"`` (the plain PyTorch version, the
HOST side). ``grad`` is the op's differentiable binding, which a
training forward takes under ``api.grad_safe_context`` (the ``"torch"``
backend where it is None): the kernels define no backward.

``KernelSpec`` lives in ``core/workload.py`` and the footprint model
the decision compares with the budget, ``kernel_footprint``, in
``core/footprint.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple

from repro_torch.core.workload import KernelSpec

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class KernelOp:
    name: str
    spec: Callable[..., KernelSpec]
    backends: Mapping[str, Callable]
    accel_order: Tuple[str, ...] = ("cuda", "torch")
    host_order: Tuple[str, ...] = ("torch",)
    doc: str = ""
    grad: Optional[Callable] = None

    def __post_init__(self):
        unknown = set(self.backends) - set(BACKENDS)
        if unknown:
            raise ValueError(f"{self.name}: unknown backends {sorted(unknown)}")
        if not self.backends:
            raise ValueError(f"{self.name}: at least one backend required")


_REGISTRY: dict[str, KernelOp] = {}


def register(op: KernelOp) -> KernelOp:
    _REGISTRY[op.name] = op
    return op


def get_op(name: str) -> KernelOp:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel op {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_ops() -> list[str]:
    """Names of the registered ops, sorted."""
    return sorted(_REGISTRY)
