"""Three-term roofline of a traced call (the JAX package's
``analysis/roofline.py``)::

    compute term    = FLOPs / (chips x peak FLOP/s)
    memory term     = bytes / (chips x memory bandwidth)
    collective term = collective bytes / (chips x link bandwidth)

The FLOPs, bytes and collective bytes are one rank's (``cost.Cost``:
the traced ops of one rank), scaled to the mesh by the chip count,
which cancels back out in the terms. The hardware constants come from
a registered ``repro_torch.platforms`` target, ``h100-sxm`` unless the
caller names another. The dominant term is the modelled step-latency
bound; MODEL_FLOPS / traced FLOPs says how much of the traced compute
is useful (it catches remat's recompute).
"""

from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.analysis.cost import Cost
from repro_torch.configs import ArchConfig
from repro_torch.platforms import Platform, get_platform

DEFAULT_PLATFORM = "h100-sxm"


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # global (= per rank x chips)
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    collectives: dict            # kind -> per-rank operand bytes
    collective_counts: dict
    notes: tuple = ()
    platform: str = DEFAULT_PLATFORM
    peak_flops: float = 0.0      # per-chip peak of the score axis

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The roofline bound: the largest of the three terms (they
        overlap on real hardware; the slowest binds)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOPs' time at peak over the bound: 1.0 is compute
        bound with nothing wasted (the score axis)."""
        if self.bound_s <= 0 or self.peak_flops <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.bound_s

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_ms": 1e3 * self.compute_s,
            "memory_ms": 1e3 * self.memory_s,
            "collective_ms": 1e3 * self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_frac": self.roofline_fraction,
        }


def roofline_from_cost(cost: Cost, *, arch: str, shape: str, mesh: str,
                       chips: int, model_flops: float,
                       platform: Union[str, Platform] = DEFAULT_PLATFORM
                       ) -> Roofline:
    plat = get_platform(platform)
    peak = plat.peak_flops("bf16")
    notes = ()
    if cost.kernels:
        notes = ("kernel calls costed by their specs: " + ",".join(
            f"{k} x{n}" for k, n in sorted(cost.kernels.items())),)
    g_flops = cost.flops * chips
    g_bytes = cost.bytes * chips
    g_coll = cost.collective_bytes * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=g_flops, hlo_bytes=g_bytes, collective_bytes=g_coll,
        compute_s=g_flops / (chips * peak),
        memory_s=g_bytes / (chips * plat.memory.main_bw),
        collective_s=g_coll / (chips * plat.memory.link_bw),
        model_flops=model_flops,
        collectives=dict(cost.collectives),
        collective_counts=dict(cost.collective_counts),
        notes=notes, platform=plat.name, peak_flops=peak)


def model_flops(cfg: ArchConfig, n_params: int, n_active: int,
                tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward only) with N the
    active parameters for MoE. ``tokens``: the global tokens of the
    step (decode: one a sequence)."""
    n = n_active if cfg.is_moe else n_params
    per_tok = 6 * n if kind == "train" else 2 * n
    return float(per_tok) * tokens
