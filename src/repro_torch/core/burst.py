"""Mixed-execution burst partitioning (paper contribution C2): the
port's copy of the JAX package's ``core/burst.py``.

IMAX processes fixed-length bursts efficiently; variable-length dot
products are split into a burst-aligned *main* segment (offloaded) and a
small *residual* tail (host CPU). ``fp16_matmul``'s ``offload_info``
reports this split for a GEMM; the planner below also reproduces the
paper's burst-length design-space exploration (burst=16 was found
optimal for Whisper's vector-length distribution).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

DEFAULT_BURST = 16


@dataclasses.dataclass(frozen=True)
class BurstSplit:
    k: int
    burst: int
    k_main: int      # burst-aligned prefix, offloaded
    k_residual: int  # tail, host path

    @property
    def offload_fraction(self) -> float:
        return self.k_main / self.k if self.k else 0.0


def split_burst(k: int, burst: int = DEFAULT_BURST) -> BurstSplit:
    if k < 0 or burst <= 0:
        raise ValueError(f"invalid split: k={k}, burst={burst}")
    k_main = (k // burst) * burst
    return BurstSplit(k=k, burst=burst, k_main=k_main, k_residual=k - k_main)


def offload_rate(lengths: Mapping[int, int] | Sequence[int],
                 burst: int = DEFAULT_BURST) -> float:
    """MAC-weighted fraction of work on the accelerator for a vector-length
    distribution. ``lengths`` is either a {K: count} histogram or a sequence
    of Ks. The paper reports ~95% offload (5% residual) at burst=16."""
    hist = dict(lengths) if isinstance(lengths, Mapping) else None
    if hist is None:
        hist = {}
        for k in lengths:
            hist[k] = hist.get(k, 0) + 1
    total = sum(k * c for k, c in hist.items())
    if total == 0:
        return 0.0
    main = sum(split_burst(k, burst).k_main * c for k, c in hist.items())
    return main / total


@dataclasses.dataclass(frozen=True)
class BurstCost:
    burst: int
    offload: float          # MAC fraction on accelerator
    accel_time: float       # modeled seconds on the accelerator
    host_time: float        # modeled seconds for the residual tail
    total_time: float       # accel + host (residual only partially hides)


def burst_cost(lengths: Mapping[int, int], burst: int, *,
               t_mac_accel: float, t_mac_host: float,
               t_burst_overhead: float) -> BurstCost:
    """Latency model behind the paper's burst-length trade-off: a larger
    burst amortizes per-burst overhead but lowers the offload rate (more
    residual work lands on the slow host path)."""
    accel = 0.0
    host = 0.0
    for k, count in lengths.items():
        s = split_burst(k, burst)
        n_bursts = s.k_main // burst
        accel += count * (s.k_main * t_mac_accel + n_bursts * t_burst_overhead)
        host += count * (s.k_residual * t_mac_host)
    return BurstCost(
        burst=burst,
        offload=offload_rate(lengths, burst),
        accel_time=accel,
        host_time=host,
        total_time=accel + host,
    )


def optimal_burst(lengths: Mapping[int, int],
                  candidates: Iterable[int] = (4, 8, 16, 32, 64, 128), *,
                  t_mac_accel: float = 1.0,
                  t_mac_host: float = 2.76,
                  t_burst_overhead: float = 0.065) -> BurstCost:
    """Sweep burst lengths and return the latency-minimizing one.

    Default cost ratios are derived from the paper-calibrated accelerator
    model (repro_torch.core.energy.calibrate_imax): the A72 host path is ~2.76x
    slower per MAC than IMAX; the per-burst setup cost (in units of one
    accelerator MAC) is bounded to [0.05, 0.08] by requiring burst=16 to
    minimize total latency over Whisper's K-length distribution — i.e. the
    paper's Sec III-B DSE outcome pins the one free parameter (larger
    bursts amortize overhead but push more residual MACs to the slow host
    path; at ov>=0.12 burst 64 would win, at ov<=0.02 burst 8 would).
    """
    best = None
    for b in candidates:
        c = burst_cost(lengths, b, t_mac_accel=t_mac_accel,
                       t_mac_host=t_mac_host, t_burst_overhead=t_burst_overhead)
        if best is None or c.total_time < best.total_time:
            best = c
    assert best is not None
    return best
