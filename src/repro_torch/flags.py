"""Process-wide switch of the port (the JAX package's ``flags.py``):
the paper-faithful-baseline A/B toggle, read once at import as the
reference reads it.

No code of the port reads ``BASELINE``: the port keeps the optimised
form at every one of the reference's ``BASELINE`` sites (the MoE
dispatch, the serving-cache sharding rules, the f32 attention upcasts,
the decode re-materialisation, the sLSTM in-scan gates, the serving
engine's refusals), and the MoE global dispatch stays reachable as
``moe_ffn(grouped=False)`` for the equivalence tests. The sites are
wired together, all at once, when a benchmark cell needs the A/B. The
reference's dispatch knobs (``REPRO_KERNEL_BACKEND``,
``REPRO_ALLOW_PALLAS``, ``REPRO_INTERPRET``, ``REPRO_VMEM_BUDGET``,
``REPRO_PLATFORM``) are not read: the port routes through
``kernels.api.DispatchContext``.
"""

import os

BASELINE = os.environ.get("REPRO_BASELINE", "") == "1"
