"""Cost analysis of the port's traced steps (the JAX package's
``repro.analysis``): ``cost`` (FLOPs, bytes, collectives and a rank's
peak memory of one call under ``FakeTensorMode``) and ``roofline``."""

from repro_torch.analysis.cost import Cost, measure
from repro_torch.analysis.roofline import (Roofline, model_flops,
                                           roofline_from_cost)

__all__ = ["Cost", "Roofline", "measure", "model_flops",
           "roofline_from_cost"]
