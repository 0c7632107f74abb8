"""Hardware targets of the port: ``Platform`` and its registry (the JAX
package's ``repro.platforms``), plus ``resolve_device``.

>>> from repro_torch.platforms import get_platform, list_platforms
>>> p = get_platform("imax3-28nm/32k")
>>> p.vmem_budget, p.platform_power("q8_0")
(32768, 1.32)

The ``Platform`` object drives kernel dispatch
(``DispatchContext.for_platform``), serving energy accounting
(``ServeEngine(platform=...).energy_report()``) and the analytic energy
model (``core.energy``). The registry holds the paper's targets and
``h100-sxm``, the card the port runs on.
"""

import torch

from repro_torch.platforms.base import (MemoryHierarchy, Platform,
                                        PowerModel, interp_power_log)
from repro_torch.platforms.builtin import (IMAX_LMM_SIZES,
                                           register_builtin_platforms)
from repro_torch.platforms.registry import (get_platform, list_platforms,
                                            platform_families,
                                            platforms_in_family,
                                            register_platform)

__all__ = [
    "MemoryHierarchy", "Platform", "PowerModel", "interp_power_log",
    "IMAX_LMM_SIZES", "get_platform", "list_platforms",
    "platform_families", "platforms_in_family", "register_platform",
    "resolve_device",
]

register_builtin_platforms()


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
