"""Kernel-op registry and the analytic footprint model behind the
ACCEL/HOST decision.

A ``KernelOp`` bundles an op's ``spec`` builder (its call's operands ->
``KernelSpec``), its backends and their order on each side of the
decision. The port's backends are ``"cuda"`` (the hand-written Hopper
kernel, the ACCEL side) and ``"torch"`` (the plain PyTorch version, the
HOST side).

``KernelSpec`` and ``kernel_footprint`` are the port's copies of the JAX
package's ``core/workload.py:35`` and ``core/footprint.py:44-64``: the
paper's LMM model (C3), which counts the bytes one call keeps resident
under the dense-packing policy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Tuple

from repro_torch.quantize import stored_bytes

BACKENDS = ("cuda", "torch")

N_TILE = 4  # the paper's column-wise multithreading depth (Sec III-B)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One mul_mat call site: A is (n, k) [weights or cached tensor],
    B is (m, k) [activations]; invoked ``count`` times per call."""

    name: str
    m: int
    n: int
    k: int
    dtype: str        # storage dtype of A: 'f16' | 'q8_0' | 'q4_0' | 'f32'
    count: int = 1
    tag: str = "proj"  # proj | attn_qk | attn_av | mlp | logits | frontend

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k * self.count


def kernel_footprint(spec: KernelSpec, policy: str = "optimized",
                     n_tile: int = N_TILE) -> int:
    """Resident bytes of one kernel call under a packing policy.

    Optimized: ``n_tile`` A-rows + one B-row + the accumulators; weight
    operands are counted converted to f32, cache operands (attention) in
    their f16 storage dtype. Baseline: the whole row-padded A plane."""
    if policy == "optimized":
        elem = 2.0 if spec.tag in ("attn_qk", "attn_av") else 4.0
        return int(elem * (n_tile * spec.k + spec.k) + 4 * n_tile)
    if policy == "baseline":
        a_bytes = stored_bytes((spec.n, spec.k), spec.dtype, "baseline")
        b_bytes = stored_bytes((spec.k,), "f16", "baseline")
        return a_bytes + b_bytes
    raise ValueError(f"unknown policy {policy!r}")


@dataclasses.dataclass(frozen=True)
class KernelOp:
    name: str
    spec: Callable[..., KernelSpec]
    backends: Mapping[str, Callable]
    accel_order: Tuple[str, ...] = ("cuda", "torch")
    host_order: Tuple[str, ...] = ("torch",)
    doc: str = ""

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
