"""Continuous-batching admission scheduler of the port (the JAX
package's ``serving/scheduler.py``).

FCFS over a ``ServeEngine``. One ``tick()``:

0. feed one pending audio chunk to every open stream, finalizing the
   streams whose audio has all arrived;
1. admit waiting requests while slots are free (each admit is one
   prefill: at a bucketed length for KV lanes, at the exact prompt length
   for recurrent ones; a streaming request opens a stream and feeds its
   first chunk);
2. run one engine tick (``decode_block`` decode steps, one host fetch);
3. collect finished requests.

A stream gets one chunk a tick, the serving-time model of real-time
arrival, so its lane decodes while its audio is still arriving (partial
hypotheses in ``RequestState.partials``) and is anchored again at the
end of its audio for the final transcript.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

from repro_torch.serving.engine import (RejectCode, Request, RequestState,
                                        RejectionError, ServeEngine,
                                        StreamingAudioRequest)


@dataclasses.dataclass
class SchedMetrics:
    ticks: int = 0
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    tokens: int = 0             # emitted under this scheduler
    occupancy_sum: float = 0.0
    queue_wait_sum: int = 0     # ticks spent waiting, summed
    ttft_sum: int = 0           # ticks from submit to first token
    queue_wait_s_sum: float = 0.0
    ttft_s_sum: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.ticks, 1)

    @property
    def mean_ttft(self) -> float:
        return self.ttft_sum / max(self.admitted, 1)

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_s_sum / max(self.admitted, 1)

    @property
    def mean_queue_wait_s(self) -> float:
        return self.queue_wait_s_sum / max(self.admitted, 1)

    @property
    def tokens_per_tick(self) -> float:
        return self.tokens / max(self.ticks, 1)


class SchedulerStuckError(RuntimeError):
    """``run_until_drained`` ran out of ticks with work still pending."""


class BatchScheduler:
    def __init__(self, engine: ServeEngine, max_admit_per_tick: int = 2):
        self.engine = engine
        self.max_admit_per_tick = max_admit_per_tick
        self.queue: deque[tuple[Request, int, float]] = deque()
        self.metrics = SchedMetrics()
        self.results: dict[int, RequestState] = {}
        # open streams: slot -> (state, pending frame chunks)
        self._streams: dict[int, tuple[RequestState, deque]] = {}

    def submit(self, req: Request) -> Optional[RequestState]:
        """Queue a request; one the engine can never serve completes at
        once as a failed state (returned), so it cannot stop the loop."""
        err = self.engine.validate(req)
        if err is not None:
            st = RequestState(req=req, slot=-1, pos=0, out=[], done=True,
                              error=str(err), error_code=err.code)
            self.results[req.uid] = st
            self.metrics.rejected += 1
            return st
        self.queue.append((req, self.metrics.ticks, time.monotonic()))
        return None

    def _feed(self, st: RequestState, pending: deque) -> None:
        """Feed a stream its next chunk; finalize it after its last."""
        self.engine.stream_feed(st, pending.popleft())
        if pending:
            self._streams[st.slot] = (st, pending)
            return
        self._streams.pop(st.slot, None)
        self.engine.stream_finalize(st)
        if st.done:
            self.metrics.completed += 1
            self.results[st.req.uid] = st

    def tick(self) -> list[RequestState]:
        m = self.metrics
        gen0 = self.engine._generated
        for st, pending in list(self._streams.values()):
            self._feed(st, pending)
        admitted = 0
        while (self.queue and self.engine.free
               and admitted < self.max_admit_per_tick):
            req, t_submit, t_wall = self.queue.popleft()
            t_admit = time.monotonic()
            stream = isinstance(req, StreamingAudioRequest)
            try:
                st = self.engine.open_stream(req) if stream \
                    else self.engine.admit(req)
            except ValueError as e:
                # a request submit()'s precheck missed: fail it, keep the
                # serving loop alive
                st = RequestState(
                    req=req, slot=-1, pos=0, out=[], done=True,
                    error=str(e), error_code=e.rejection.code
                    if isinstance(e, RejectionError) else None)
                self.results[req.uid] = st
                m.rejected += 1
                continue
            if st is None:
                self.queue.appendleft((req, t_submit, t_wall))
                break
            if stream:
                # the first token exists once the first chunk anchored
                self._feed(st, deque(req.chunks))
            m.admitted += 1
            m.queue_wait_sum += m.ticks - t_submit
            m.ttft_sum += m.ticks - t_submit   # first token at admit
            m.queue_wait_s_sum += t_admit - t_wall
            m.ttft_s_sum += time.monotonic() - t_wall
            admitted += 1
            if st.done and req.uid not in self.results:
                m.completed += 1
                self.results[req.uid] = st
        finished = self.engine.step()
        for st in finished:
            m.completed += 1
            self.results[st.req.uid] = st
        m.ticks += 1
        m.tokens += self.engine._generated - gen0
        m.occupancy_sum += self.engine.n_active / self.engine.n_slots
        return finished

    def abort(self, uid) -> Optional[RequestState]:
        """Cancel a queued or in-flight request or an open stream by
        uid."""
        for i, (req, _t, _w) in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                st = RequestState(
                    req=req, slot=-1, pos=0, out=[], done=True,
                    error=f"request {uid} cancelled while queued",
                    error_code=RejectCode.CANCELLED)
                self.results[uid] = st
                return st
        for slot, (st, _pending) in list(self._streams.items()):
            if st.req.uid == uid:
                del self._streams[slot]
                self.engine.abort(st)
                self.results[uid] = st
                return st
        for st in list(self.engine.active.values()):
            if st.req.uid == uid:
                self.engine.abort(st)
                self.results[uid] = st
                return st
        return None

    def run_until_drained(self, max_ticks: int = 10_000, *,
                          strict: bool = True) -> bool:
        """Tick until every request and stream completes, at most
        ``max_ticks`` ticks; a load that does not drain raises (or, with
        ``strict=False``, returns False)."""
        budget = max_ticks
        while (self.queue or self._streams or self.engine.n_active) \
                and budget > 0:
            self.tick()
            budget -= 1
        if not self.drained:
            if strict:
                raise SchedulerStuckError(
                    f"scheduler not drained after {max_ticks} ticks: "
                    f"{len(self.queue)} queued, {len(self._streams)} open "
                    f"streams, {self.engine.n_active} active lanes")
            return False
        return True

    @property
    def drained(self) -> bool:
        return (not self.queue and not self._streams
                and self.engine.n_active == 0)
