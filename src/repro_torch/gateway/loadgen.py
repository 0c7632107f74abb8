"""Seeded open-loop Poisson load generation for the gateway (the JAX
package's ``gateway/loadgen.py``).

Open-loop means arrivals are scheduled on a fixed clock **independent
of completions** — the generator does not wait for one request to
finish before sending the next, so the measured latencies include real
queueing (a closed-loop generator self-throttles and hides overload,
the classic coordinated-omission trap). Inter-arrival gaps are drawn
from a seeded exponential distribution (``numpy.random.default_rng``),
so a (rate, n, seed) triple always reproduces the exact same workload:
same arrival offsets, same audio, same prompts, same SLO mix.

``sync_baseline`` replays the identical request set through the
synchronous ``BatchScheduler`` — the token-parity oracle for the
gateway (per-lane cache isolation makes engine outputs independent of
admission order/composition, so the two must agree token-for-token).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.gateway.gateway import Gateway, GatewayResult
from repro_torch.gateway.slo import BATCH, INTERACTIVE, STANDARD, SLOClass
from repro_torch.serving.engine import (AudioRequest, ServeEngine,
                                        StreamingAudioRequest)
from repro_torch.serving.scheduler import BatchScheduler

# Nominal seconds of source audio one encoder frame covers (Whisper's
# 2x-strided conv over 20 ms hops) — used only for J/audio-s accounting.
AUDIO_S_PER_FRAME = 0.04


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One load point: arrival rate + workload shape, fully seeded."""

    rate_rps: float                 # mean arrival rate (open loop)
    n_requests: int = 32
    seed: int = 0
    stream_fraction: float = 0.25   # fraction served as streaming sessions
    max_new: int = 8
    # (frame counts for one-shot audio, chunk sizes are fixed) — a small
    # fixed set keeps the number of distinct shapes bounded under load
    oneshot_frames: tuple = (8, 12)
    stream_chunk_frames: int = 4
    stream_chunks: tuple = (2, 3)
    slo_mix: tuple = ((INTERACTIVE, 0.5), (STANDARD, 0.3), (BATCH, 0.2))


@dataclasses.dataclass
class RequestDesc:
    """One synthesized request: everything both serving paths need."""

    idx: int
    kind: str                       # "oneshot" | "stream"
    arrival_s: float                # offset from load start
    tokens: list
    max_new: int
    eos_id: int
    chunks: list                    # one array (oneshot) or several
    slo: SLOClass
    audio_s: float

    @property
    def frames(self) -> np.ndarray:
        return np.concatenate(self.chunks, axis=0)


def poisson_arrivals(rate_rps: float, n: int, seed: int) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a seeded Poisson process:
    exponential inter-arrival gaps with mean ``1/rate_rps``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


def synth_load(cfg, spec: LoadSpec) -> list[RequestDesc]:
    """Deterministic workload for one ``LoadSpec``: mixed one-shot and
    streaming audio requests with Poisson arrivals and the spec's SLO
    mix. Same spec → identical descriptors, bit-for-bit."""
    arrivals = poisson_arrivals(spec.rate_rps, spec.n_requests, spec.seed)
    rng = np.random.default_rng(spec.seed + 1)
    slos = [s for s, _ in spec.slo_mix]
    weights = np.asarray([w for _, w in spec.slo_mix], np.float64)
    weights = weights / weights.sum()
    descs = []
    for i in range(spec.n_requests):
        streaming = rng.random() < spec.stream_fraction
        slo = slos[int(rng.choice(len(slos), p=weights))]
        prompt = [1] + [int(t) for t in
                        rng.integers(2, min(cfg.vocab, 200),
                                     size=int(rng.integers(0, 3)))]
        if streaming:
            n_chunks = int(rng.choice(spec.stream_chunks))
            chunks = [rng.standard_normal(
                (spec.stream_chunk_frames, cfg.d_model)
            ).astype(np.float32) * 0.02 for _ in range(n_chunks)]
        else:
            s = int(rng.choice(spec.oneshot_frames))
            chunks = [rng.standard_normal((s, cfg.d_model)
                                          ).astype(np.float32) * 0.02]
        n_frames = sum(c.shape[0] for c in chunks)
        descs.append(RequestDesc(
            idx=i, kind="stream" if streaming else "oneshot",
            arrival_s=float(arrivals[i]), tokens=prompt,
            max_new=spec.max_new, eos_id=-1, chunks=chunks, slo=slo,
            audio_s=n_frames * AUDIO_S_PER_FRAME))
    return descs


async def _serve_one(gw: Gateway, desc: RequestDesc, start_t: float,
                     timeout_s: Optional[float]) -> GatewayResult:
    # open loop: sleep to the absolute arrival offset, regardless of
    # what every other request is doing
    delay = start_t + desc.arrival_s - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)
    if desc.kind == "oneshot":
        return await gw.submit_audio(
            frames=desc.frames, tokens=desc.tokens, max_new=desc.max_new,
            eos_id=desc.eos_id, slo=desc.slo, timeout_s=timeout_s,
            audio_s=desc.audio_s)
    sess = await gw.open_session(tokens=desc.tokens, max_new=desc.max_new,
                                 eos_id=desc.eos_id, slo=desc.slo,
                                 audio_s=desc.audio_s)
    for chunk in desc.chunks:
        if sess.done:
            break
        await sess.feed(chunk)
    return await sess.finalize(timeout_s=timeout_s)


async def offered_load(gw: Gateway, descs: Sequence[RequestDesc], *,
                       timeout_s: Optional[float] = None
                       ) -> list[GatewayResult]:
    """Offer the whole workload open-loop; results in descriptor order
    (shed/timeout requests come back with ``ok=False``, never raise)."""
    start_t = time.monotonic()
    return list(await asyncio.gather(
        *(_serve_one(gw, d, start_t, timeout_s) for d in descs)))


def run_load(engine: ServeEngine, spec: LoadSpec, *,
             queue_limit: int = 64, max_admit_per_tick: int = 2,
             shed_on_submit: bool = True,
             timeout_s: Optional[float] = None):
    """Synthesize ``spec``'s workload, serve it through a fresh
    ``Gateway`` over ``engine``, and return
    ``(results, summary_dict, gateway)``."""
    descs = synth_load(engine.model.cfg, spec)

    async def _go():
        async with Gateway(engine, queue_limit=queue_limit,
                           max_admit_per_tick=max_admit_per_tick,
                           shed_on_submit=shed_on_submit) as gw:
            results = await offered_load(gw, descs, timeout_s=timeout_s)
        return results, gw

    results, gw = asyncio.run(_go())
    return results, gw.report(), gw


def sync_baseline(engine: ServeEngine, descs: Sequence[RequestDesc], *,
                  max_ticks: int = 10_000) -> dict[int, list]:
    """Serve the same descriptors through the synchronous FCFS
    ``BatchScheduler``: ``desc.idx -> final tokens``. The gateway must
    match this token-for-token (the parity oracle)."""
    sched = BatchScheduler(engine)
    uid0 = 1_000_000
    for d in descs:
        if d.kind == "stream":
            req = StreamingAudioRequest(
                uid=uid0 + d.idx, tokens=list(d.tokens),
                max_new=d.max_new, eos_id=d.eos_id,
                chunks=list(d.chunks))
        else:
            req = AudioRequest(uid=uid0 + d.idx, tokens=list(d.tokens),
                               max_new=d.max_new, eos_id=d.eos_id,
                               enc_frames=d.frames)
        sched.submit(req)
    sched.run_until_drained(max_ticks)
    return {d.idx: list(sched.results[uid0 + d.idx].out) for d in descs}
