"""repro_torch.staticcheck -- static verification of the port's serving
hot path (the JAX package's ``repro.staticcheck``).

Traces the eager tick (the body the card captures in a CUDA graph), the
device part of a prefill, the streaming cross-cache extension and the
frontend projection as aten-level op traces, then verifies the serving
contract on them: buffers updated in place, no host sync inside a
program, no plane-sized f32 copy of a storage-dtype plane, one CUDA
graph per tick size with no recapture, and the kernel registry's
analytic footprints against what the host backends run.

CLI: ``python -m repro_torch.staticcheck [--json [PATH]] [--only IDS]
[--device cuda|cpu]``. Intentional exceptions live in the port's
``staticcheck.toml``, beside this package's modules.
"""

from repro_torch.staticcheck.config import StaticcheckConfig
from repro_torch.staticcheck.report import Finding, Report
from repro_torch.staticcheck.run import ALL_CHECKS, bench_record, run_all

__all__ = ["ALL_CHECKS", "Finding", "Report", "StaticcheckConfig",
           "bench_record", "run_all"]
