"""Wall-clock serving observability for the gateway (the JAX package's
``gateway/metrics.py``).

Everything here is measured in **seconds** (``time.monotonic``), not
ticks: the numbers an operator alarms on. One ``RequestRecord`` per
finished (or shed) request; ``GatewayMetrics.summary()`` aggregates:

* p50/p99 time-to-first-token and end-to-end latency,
* streaming lag (how long a fed audio chunk waited before the engine
  attended it) — mean and p99 across all delivered chunks,
* **goodput**: completed-within-deadline requests per second — the
  throughput number that actually respects the SLO (a request finishing
  after its deadline counts toward throughput but not goodput),
* shed/timeout/cancel counts classified by ``RejectCode``,
* J/audio-s when the engine has a platform (``energy_report()`` folded
  over the served audio seconds).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import numpy as np

from repro_torch.serving.engine import RejectCode


def percentile(values, q) -> float:
    """p-th percentile of a list (0.0 when empty) — nearest-rank via
    numpy, returned as a plain float for JSON."""
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps (``time.monotonic`` seconds) and outcome of
    one gateway request."""

    uid: int
    slo: str
    submit_t: float
    deadline_t: float
    admit_t: Optional[float] = None        # queue popped, pre-prefill
    first_token_t: Optional[float] = None  # prefill/anchor argmax fetched
    done_t: Optional[float] = None
    n_tokens: int = 0
    audio_s: float = 0.0                   # seconds of audio served
    ok: bool = False                       # completed with tokens
    code: Optional[RejectCode] = None      # shed/abort classification
    streaming: bool = False
    chunk_lags: list = dataclasses.field(default_factory=list)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    @property
    def in_deadline(self) -> bool:
        return self.ok and self.done_t is not None \
            and self.done_t <= self.deadline_t


class GatewayMetrics:
    """Aggregates ``RequestRecord``s; ``summary()`` is the JSON-ready
    rollup of a load run."""

    def __init__(self, clock=None):
        self.records: list[RequestRecord] = []
        self.shed: Counter = Counter()     # RejectCode.value -> n
        self.ticks = 0                     # gateway tick-loop iterations
        self.started_t: Optional[float] = None
        self.stopped_t: Optional[float] = None

    def record(self, rec: RequestRecord) -> None:
        self.records.append(rec)
        if rec.code is not None:
            self.shed[rec.code.value] += 1

    # ------------------------------------------------------------------
    def summary(self, energy: Optional[dict] = None) -> dict:
        """The rollup. ``energy``: an ``engine.energy_report()`` dict —
        folds in J/audio-s over the audio seconds actually served."""
        ok = [r for r in self.records if r.ok]
        ttft = [r.ttft_s for r in ok if r.ttft_s is not None]
        e2e = [r.e2e_s for r in ok if r.e2e_s is not None]
        waits = [r.queue_wait_s for r in ok if r.queue_wait_s is not None]
        lags = [lag for r in ok for lag in r.chunk_lags]
        in_deadline = sum(r.in_deadline for r in ok)
        wall = 0.0
        if self.started_t is not None:
            end = self.stopped_t if self.stopped_t is not None else max(
                [r.done_t for r in ok if r.done_t is not None],
                default=self.started_t)
            wall = max(end - self.started_t, 1e-9)
        audio_s = sum(r.audio_s for r in ok)
        out = {
            "requests": len(self.records),
            "completed": len(ok),
            "completed_in_deadline": in_deadline,
            "deadline_misses": len(ok) - in_deadline,
            "shed": dict(sorted(self.shed.items())),
            "shed_total": sum(self.shed.values()),
            "ticks": self.ticks,
            "wall_s": wall,
            "throughput_rps": len(ok) / wall if wall else 0.0,
            "goodput_rps": in_deadline / wall if wall else 0.0,
            "tokens": sum(r.n_tokens for r in ok),
            "audio_s": audio_s,
            "ttft_s": {"p50": percentile(ttft, 50),
                       "p99": percentile(ttft, 99),
                       "mean": float(np.mean(ttft)) if ttft else 0.0},
            "e2e_s": {"p50": percentile(e2e, 50),
                      "p99": percentile(e2e, 99),
                      "mean": float(np.mean(e2e)) if e2e else 0.0},
            "queue_wait_s": {"p50": percentile(waits, 50),
                             "p99": percentile(waits, 99)},
            "stream_lag_s": {"mean": float(np.mean(lags)) if lags else 0.0,
                             "p99": percentile(lags, 99),
                             "chunks": len(lags)},
        }
        if energy is not None:
            out["energy"] = {
                "platform": energy.get("platform"),
                "pdp_j": energy.get("pdp_j"),
                "joules_per_token": energy.get("joules_per_token"),
                "joules_per_audio_s":
                    (energy.get("pdp_j", 0.0) / audio_s) if audio_s else 0.0,
            }
        return out
