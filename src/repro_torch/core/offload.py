"""ACCEL/HOST offload planning + execution-time breakdown (paper C5,
Fig 7): the port's copy of the JAX package's ``core/offload.py``.

The paper's control law: a kernel is offloaded to IMAX iff its (optimized)
working set fits the LMM; everything else — plus the burst residual — runs
on the host CPU. Execution time on the accelerator decomposes into

* ``EXEC``        — pure PE compute,
* ``LOAD/DRAIN``  — DRAM↔LMM traffic,
* ``CONF``        — per-call configuration (CONF/REGV/RANGE/REFILL).

On the port's card the analogues are the kernels' arithmetic, device
memory traffic and the per-kernel launch (``energy.accel_model_for``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.burst import DEFAULT_BURST, split_burst
from repro_torch.core.footprint import elem_bytes, kernel_footprint
from repro_torch.core.workload import KernelSpec


@dataclasses.dataclass(frozen=True)
class AccelModel:
    """Calibratable accelerator latency model."""
    name: str
    flops_rate: float        # effective FLOP/s on the accelerator
    mem_bw: float            # DRAM<->LMM (device memory) bytes/s
    conf_time: float         # seconds per kernel call (CONF/launch)
    host_flops_rate: float   # effective FLOP/s of the host/fallback path
    burst: int = DEFAULT_BURST


@dataclasses.dataclass(frozen=True)
class Plan:
    budget_bytes: int
    policy: str
    accel: tuple[KernelSpec, ...]
    host: tuple[KernelSpec, ...]

    @property
    def coverage_calls(self) -> float:
        a = sum(s.calls for s in self.accel)
        h = sum(s.calls for s in self.host)
        return a / max(a + h, 1)

    @property
    def coverage_flops(self) -> float:
        a = sum(s.flops for s in self.accel)
        h = sum(s.flops for s in self.host)
        return a / max(a + h, 1)


def offload_decision(spec: KernelSpec, budget_bytes: int,
                     policy: str = "optimized") -> str:
    """The paper's per-kernel control law: ``"accel"`` iff the (policy)
    working set fits the LMM budget, else ``"host"``. This single
    predicate backs both the analytic planner below and the executable
    dispatch layer (``repro_torch.kernels.api``)."""
    fits = kernel_footprint(spec, policy) <= budget_bytes
    return "accel" if fits else "host"


def plan_offload(work: Sequence[KernelSpec], budget_bytes: int,
                 policy: str = "optimized") -> Plan:
    accel, host = [], []
    for spec in work:
        (accel if offload_decision(spec, budget_bytes, policy) == "accel"
         else host).append(spec)
    return Plan(budget_bytes, policy, tuple(accel), tuple(host))


@dataclasses.dataclass(frozen=True)
class Breakdown:
    exec_s: float
    load_s: float
    conf_s: float
    host_s: float            # non-offloaded kernels + burst residual

    @property
    def accel_s(self) -> float:
        return self.exec_s + self.load_s + self.conf_s

    @property
    def total_s(self) -> float:
        # Residual overlaps the accelerator (Sec III-B) but whole fallback
        # kernels serialize; we fold both into host_s and serialize — the
        # paper's Fig 6 shows the 16 KB case degrading exactly this way.
        return self.accel_s + self.host_s

    @property
    def exec_share(self) -> float:
        a = self.accel_s
        return self.exec_s / a if a else 0.0


def staged_bytes(spec: KernelSpec) -> int:
    """DRAM->LMM traffic for one kernel call under the optimized (packed)
    policy: the A tile stream (storage dtype — this is where Q8_0 wins),
    the B row, and the drained output."""
    a = spec.n * spec.k * elem_bytes(spec.dtype)
    b = spec.k * elem_bytes("f16")
    out = spec.n * 4
    return int(a + b + out)


def execution_breakdown(work: Sequence[KernelSpec], model: AccelModel,
                        budget_bytes: int,
                        policy: str = "optimized") -> Breakdown:
    plan = plan_offload(work, budget_bytes, policy)
    exec_s = load_s = conf_s = host_s = 0.0
    for spec in plan.accel:
        s = split_burst(spec.k, model.burst)
        frac_main = s.offload_fraction
        exec_s += spec.flops * frac_main / model.flops_rate
        load_s += staged_bytes(spec) * spec.calls / model.mem_bw
        conf_s += spec.calls * model.conf_time
        host_s += spec.flops * (1.0 - frac_main) / model.host_flops_rate
    for spec in plan.host:
        host_s += spec.flops / model.host_flops_rate
    return Breakdown(exec_s, load_s, conf_s, host_s)
