"""Hardware targets for the port: ``Platform`` and its registry.

The port's copy of the parts of the JAX package's ``repro.platforms``
that dispatch and ``ServeEngine.energy_report`` read: the memory
hierarchy (whose ``local_bytes`` is the budget of the ACCEL/HOST control
law), per-dtype peak rates and a power model. One target is registered:
the NVIDIA H100 SXM, the card the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

__all__ = ["MemoryHierarchy", "PowerModel", "Platform", "get_platform",
           "list_platforms", "register_platform", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """``local_bytes`` is the LMM/VMEM-like budget of the control law:
    on Hopper, the shared memory one thread block can use."""
    local_bytes: int
    main_bytes: int = 0        # device memory capacity
    main_bw: float = 0.0       # device memory rate, bytes/s
    link_bw: float = 0.0       # card-to-card interconnect, bytes/s


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Flat nominal power scaled by compute utilization."""
    nominal_w: float
    idle_w: float = 0.0

    def power(self, kernel: str = "fp16", local_bytes=None,
              lanes: int = 1, util: float = 1.0) -> float:
        return self.idle_w + util * (self.nominal_w - self.idle_w)


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
    name: str
    family: str
    kind: str                  # "gpu" for every target of the port
    memory: MemoryHierarchy
    power: PowerModel
    compute: Mapping[str, float] = dataclasses.field(default_factory=dict)
    policy: str = "optimized"
    aliases: tuple = ()
    notes: str = ""

    @property
    def vmem_budget(self) -> int:
        """The budget the offload control law compares footprints with."""
        return self.memory.local_bytes

    def peak_flops(self, dtype: str = "bf16") -> float:
        """Peak FLOP/s (or OP/s) for ``dtype``, along the fallback chain."""
        for d in _DTYPE_FALLBACK.get(dtype, (dtype, "f32", "bf16", "f16")):
            if d in self.compute:
                return self.compute[d]
        raise KeyError(f"platform {self.name!r} has no compute rate for "
                       f"{dtype!r} (has {sorted(self.compute)})")


#: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet (dense
#: rates, no sparsity) and the Hopper tuning guide (shared memory per
#: block). These rates assume the card's full 700 W power limit.
H100_SXM = Platform(
    name="h100-sxm",
    family="h100",
    kind="gpu",
    memory=MemoryHierarchy(
        local_bytes=232_448,          # 227 KB of shared memory per block
        main_bytes=80 * 10**9,        # 80 GB HBM3
        main_bw=3.35e12,              # 3.35 TB/s
        link_bw=450e9,                # NVLink 900 GB/s, 450 GB/s each way
    ),
    power=PowerModel(nominal_w=700.0),
    compute={
        "bf16": 989e12,
        "f16": 989e12,
        "int8": 1979e12,
        "f32": 67e12,                 # CUDA cores, outside the tensor cores
    },
    aliases=("h100",),
    notes="NVIDIA H100 SXM datasheet figures; the card may run below "
          "its 700 W limit, which lowers what it reaches",
)

_REGISTRY: dict[str, Platform] = {}
_ALIASES: dict[str, str] = {}


def register_platform(p: Platform) -> Platform:
    _REGISTRY[p.name] = p
    for a in p.aliases:
        _ALIASES[a] = p.name
    return p


def get_platform(name) -> Platform:
    """Resolve a name, an alias, or a ``Platform`` (returned as is)."""
    if isinstance(name, Platform):
        return name
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(f"unknown platform {name!r}; registered: "
                       f"{list_platforms()}") from None


def list_platforms() -> list[str]:
    return sorted(_REGISTRY)


register_platform(H100_SXM)


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when the caller
    names one, else ``cuda``. Without a CUDA device and without an
    explicit ``device`` this raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
