"""Platform model: one object per hardware target (the JAX package's
``platforms/base.py``).

A ``Platform`` bundles what the port knows about one target: identity,
the memory hierarchy (whose ``local_bytes`` is the budget of the paper's
ACCEL/HOST control law), per-dtype compute rates, a ``PowerModel`` (flat
nominal power and/or the Table-II power-vs-LMM curves), an optional
calibratable ``AccelModel`` latency model, the paper's published
observables for the target, and the packing ``policy`` that
``DispatchContext.for_platform`` derives its routing from.

The reference's ``allow_pallas`` is not carried: the port has no Pallas,
and its dispatch binds the CUDA kernel to every CUDA tensor whatever the
platform (``kernels/api.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

from repro_torch.core.offload import AccelModel

__all__ = ["MemoryHierarchy", "PowerModel", "Platform", "interp_power_log"]


def interp_power_log(table: Mapping[int, float], size_bytes: int) -> float:
    """Log-linear interpolation of a power-vs-size table (Table II):
    linear in ``log(size)``, so the geometric-mean size maps to the
    arithmetic-mean power. Clamps outside the table's span."""
    if size_bytes <= 0:
        raise ValueError(f"size_bytes must be positive, got {size_bytes}")
    pts = sorted(table.items())
    if size_bytes <= pts[0][0]:
        return pts[0][1]
    if size_bytes >= pts[-1][0]:
        return pts[-1][1]
    for (s0, p0), (s1, p1) in zip(pts, pts[1:]):
        if s0 <= size_bytes <= s1:
            t = (math.log(size_bytes) - math.log(s0)) \
                / (math.log(s1) - math.log(s0))
            return p0 + t * (p1 - p0)
    raise AssertionError


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """The two levels the offload control law cares about.

    ``local_bytes`` is the LMM-like budget of the control law (on Hopper,
    the shared memory one thread block can use). 0 means the target has
    no kernel-offload surface (a plain host: every op routes HOST)."""
    local_bytes: int
    main_bytes: int = 0        # DRAM / device memory capacity
    main_bw: float = 0.0       # DRAM<->local stream, bytes/s
    link_bw: float = 0.0       # chip-to-chip interconnect, bytes/s


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Flat nominal power and/or power-vs-local-memory curves.

    ``curves`` maps a kernel family (``"fp16"`` / ``"q8_0"``) to a
    {local_bytes: watts} table (paper Table II). Targets without curves
    (fixed silicon) fall back to utilization-scaled nominal power."""
    nominal_w: float
    idle_w: float = 0.0
    curves: Mapping[str, Mapping[int, float]] = \
        dataclasses.field(default_factory=dict)

    def power(self, kernel: str = "fp16", local_bytes: Optional[int] = None,
              lanes: int = 1, util: float = 1.0) -> float:
        """Watts for one configuration. Curve targets interpolate
        (log-linearly) at ``local_bytes`` for the ``kernel`` family and
        scale by ``lanes``; flat targets return idle + util*(nominal-idle)."""
        curve = self.curves.get(kernel)
        if curve is not None and local_bytes is not None:
            return lanes * interp_power_log(curve, local_bytes)
        return self.idle_w + util * (self.nominal_w - self.idle_w)


# dtype fallback chains for peak_flops lookups
_DTYPE_FALLBACK = {
    "q8_0": ("q8_0", "int8", "f16", "bf16", "f32"),
    "int8": ("int8", "q8_0", "f16", "bf16", "f32"),
    "f16": ("f16", "bf16", "f32"),
    "bf16": ("bf16", "f16", "f32"),
    "f32": ("f32", "bf16", "f16"),
}


@dataclasses.dataclass(frozen=True)
class Platform:
    """One hardware target, registry-addressable by ``name``."""
    name: str                  # registry key, e.g. "imax3-28nm/32k"
    family: str                # device family, e.g. "imax3-28nm"
    kind: str                  # "cgla" | "cpu" | "gpu"
    memory: MemoryHierarchy
    power: PowerModel
    # dtype -> effective FLOP/s ("f32", "bf16", "f16", "int8", "q8_0")
    compute: Mapping[str, float] = dataclasses.field(default_factory=dict)
    freq_hz: float = 0.0
    # optional calibratable latency model (core.offload.AccelModel)
    accel_model: Optional[AccelModel] = None
    # paper reference observables: {"latency_s": {"fp16": ...}, "pdp_j": ...}
    paper: Mapping[str, Mapping[str, float]] = \
        dataclasses.field(default_factory=dict)
    # the packing policy DispatchContext.for_platform derives
    policy: str = "optimized"
    aliases: tuple = ()
    notes: str = ""

    @property
    def vmem_budget(self) -> int:
        """The budget the offload control law compares footprints with."""
        return self.memory.local_bytes

    def peak_flops(self, dtype: str = "bf16") -> float:
        """Effective FLOP/s for ``dtype``, following the fallback chain
        (e.g. a target without an int8 rate serves q8_0 at its f16 rate)."""
        for d in _DTYPE_FALLBACK.get(dtype, (dtype, "f32", "bf16", "f16")):
            if d in self.compute:
                return self.compute[d]
        raise KeyError(f"platform {self.name!r} has no compute rate for "
                       f"{dtype!r} (has {sorted(self.compute)})")

    def platform_power(self, kernel: str = "fp16", lanes: int = 1,
                       util: float = 1.0) -> float:
        """Watts at this platform's own local-memory size."""
        return self.power.power(kernel, self.memory.local_bytes or None,
                                lanes=lanes, util=util)

    def with_accel_model(self, model: AccelModel) -> "Platform":
        """A copy carrying a (e.g. freshly calibrated) latency model."""
        return dataclasses.replace(self, accel_model=model)

    def paper_observable(self, key: str, kernel: str) -> Optional[float]:
        """A published observable (``key`` in {"latency_s","pdp_j",
        "exec_share"}) for a kernel family, or None if unpublished."""
        return self.paper.get(key, {}).get(kernel)
