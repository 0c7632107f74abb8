"""The paper's analytic model as reusable components (the JAX package's
``core``, without its quantization, which the port keeps in
``repro_torch.quantize``).

C2 mixed execution        -> repro_torch.core.burst
C3 packing / footprints   -> repro_torch.core.footprint
C4 LMM sizing DSE         -> repro_torch.core.footprint, repro_torch.core.energy
C5 energy methodology     -> repro_torch.core.energy, repro_torch.core.offload
workload extraction       -> repro_torch.core.workload

``core.energy`` reads the platform registry (``repro_torch.platforms``),
which itself imports ``core.offload``; it is not imported here, so that
the registry can load this package first.
"""

from repro_torch.core.burst import (BurstSplit, burst_cost, offload_rate,
                                    optimal_burst, split_burst)
from repro_torch.core.footprint import (BlockShape, coverage_cdf,
                                        kernel_footprint, select_blocks)
from repro_torch.core.offload import (AccelModel, Breakdown, Plan,
                                      execution_breakdown, offload_decision,
                                      plan_offload)
from repro_torch.core.workload import (KernelSpec, WhisperDims,
                                       k_length_histogram, lm_workload,
                                       whisper_workload)

__all__ = [
    "AccelModel", "BlockShape", "Breakdown", "BurstSplit", "KernelSpec",
    "Plan", "WhisperDims", "burst_cost", "coverage_cdf",
    "execution_breakdown", "k_length_histogram", "kernel_footprint",
    "lm_workload", "offload_decision", "offload_rate", "optimal_burst",
    "plan_offload", "select_blocks", "split_burst", "whisper_workload",
]
