"""Async serving gateway (the JAX package's ``repro.gateway``): SLO-aware
continuous batching over ``ServeEngine`` with earliest-deadline-first
admission, load shedding, wall-clock observability, and a seeded Poisson
load generator."""

from repro_torch.gateway.gateway import Gateway, GatewayResult, StreamSession
from repro_torch.gateway.loadgen import (AUDIO_S_PER_FRAME, LoadSpec,
                                         RequestDesc, offered_load,
                                         poisson_arrivals, run_load,
                                         sync_baseline, synth_load)
from repro_torch.gateway.metrics import (GatewayMetrics, RequestRecord,
                                         percentile)
from repro_torch.gateway.slo import (BATCH, DEFAULT_CLASSES, INTERACTIVE,
                                     STANDARD, AdmissionQueue, SLOClass)

__all__ = [
    "AUDIO_S_PER_FRAME", "AdmissionQueue", "BATCH", "DEFAULT_CLASSES",
    "Gateway", "GatewayMetrics", "GatewayResult", "INTERACTIVE", "LoadSpec",
    "RequestDesc", "RequestRecord", "SLOClass", "STANDARD", "StreamSession",
    "offered_load", "percentile", "poisson_arrivals", "run_load",
    "sync_baseline", "synth_load",
]
