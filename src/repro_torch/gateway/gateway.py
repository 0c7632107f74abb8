"""Async serving gateway: the traffic layer in front of ``ServeEngine``
(the JAX package's ``gateway/gateway.py``).

``Gateway`` turns the hand-cranked ``BatchScheduler`` loop into a front
door: many concurrent clients submit one-shot
(``submit_tokens``/``submit_audio``) and streaming
(``open_session``/``feed``/``finalize``) requests as awaitables, each
tagged with an :class:`~repro_torch.gateway.slo.SLOClass` (deadline +
priority). Admission is **earliest-deadline-first within priority
class** over a bounded queue (``AdmissionQueue``); a full queue or an
already-unmeetable deadline sheds the request at submit with a
structured ``RejectCode`` instead of growing a backlog.

Double-buffered tick loop (one background asyncio task)::

     tick N on device                host (event loop)
    ┌─────────────────────┐   ┌──────────────────────────────────┐
    │ decode tick (a      │   │ resolve futures / accept submits │
    │ replayed CUDA graph,│ ∥ │ shed expired queue entries       │
    │ decode_block steps) │   │ pick tick N+1's admissions (EDF) │
    └──────────┬──────────┘   └──────────────────────────────────┘
               │ one host sync: (K, n_slots) tokens + emit mask
               ▼              (fetched in an executor — the event
        replay bookkeeping     loop stays live during the wait)

``step_begin`` enqueues the tick on the device and returns at once (CUDA
launches are asynchronous; a captured engine replays the tick's graph);
the blocking ``step_fetch`` runs in a thread-pool executor, on the
tick's stream, so client coroutines keep running while the device
decodes. Admissions *picked* during tick N prefill at the next tick
boundary (their one-scalar first-token fetch queues behind the tick in
flight). The one-host-sync-per-tick invariant of the decode loop is
preserved under load — the gateway adds no device round trip.

Token parity: for the same request set, gateway results are
token-identical to the synchronous ``BatchScheduler`` (per-lane cache
isolation makes outputs independent of admission composition;
``loadgen.sync_baseline`` is the oracle).
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch.gateway.metrics import GatewayMetrics, RequestRecord
from repro_torch.gateway.slo import (BATCH, INTERACTIVE, STANDARD,
                                     AdmissionQueue, SLOClass)
from repro_torch.serving.engine import (AudioRequest, RejectCode,
                                        RejectionError, Request,
                                        RequestState, ServeEngine,
                                        StreamingAudioRequest)


@dataclasses.dataclass
class GatewayResult:
    """What one gateway request produced. ``ok=False`` carries the shed
    / abort classification in ``code`` (+ human ``error``) — shedding
    resolves the awaitable with a result, it does not raise."""

    uid: int
    ok: bool
    tokens: list
    partials: list
    slo: str
    code: Optional[RejectCode]
    error: Optional[str]
    record: RequestRecord

    @property
    def ttft_s(self) -> Optional[float]:
        return self.record.ttft_s

    @property
    def e2e_s(self) -> Optional[float]:
        return self.record.e2e_s

    @property
    def in_deadline(self) -> bool:
        return self.record.in_deadline


@dataclasses.dataclass
class _Ticket:
    """Internal per-request lifecycle state (queue entry + running)."""

    uid: int
    slo: SLOClass
    kind: str                       # "oneshot" | "stream"
    fut: asyncio.Future
    rec: RequestRecord
    req: Optional[Request] = None   # one-shot: the prebuilt request
    # streaming fields
    tokens: Sequence = ()
    max_new: int = 16
    eos_id: int = -1
    chunks: list = dataclasses.field(default_factory=list)
    chunk_t: list = dataclasses.field(default_factory=list)
    delivered: int = 0
    eos: bool = False               # finalize() called
    finalized: bool = False         # engine re-anchor ran
    # lifecycle
    state: Optional[RequestState] = None
    queued: bool = False
    cancelled: bool = False
    done: bool = False
    result: Optional[GatewayResult] = None

    @property
    def deadline_t(self) -> float:
        return self.rec.deadline_t


class Gateway:
    """Asyncio front door over one ``ServeEngine``.

    Use as an async context manager (starts/stops the background tick
    loop), or call ``start()``/``close()`` explicitly::

        async with Gateway(engine) as gw:
            r = await gw.submit_audio(frames, slo=INTERACTIVE)

    ``queue_limit`` bounds the admission queue (backpressure →
    ``RejectCode.QUEUE_FULL`` sheds); ``max_admit_per_tick`` caps
    prefills per tick boundary; ``shed_on_submit`` enables the
    deadline-unmeetable estimate shed (off until the tick/admit time
    estimators have warmed up past the first ticks, which build the
    kernels and capture the tick).
    """

    def __init__(self, engine: ServeEngine, *, queue_limit: int = 64,
                 max_admit_per_tick: int = 2,
                 shed_on_submit: bool = True,
                 idle_wait_s: float = 0.02,
                 page_shed_headroom: float = 0.1,
                 shed_batch_priority: int = BATCH.priority):
        self.engine = engine
        self.queue = AdmissionQueue(queue_limit)
        self.max_admit_per_tick = max_admit_per_tick
        self.shed_on_submit = shed_on_submit
        self.idle_wait_s = idle_wait_s
        # paged engines: when the tighter page pool's free fraction
        # drops below this, queued work at/below ``shed_batch_priority``
        # (BATCH by default) is shed with POOL_EXHAUSTED so interactive
        # admissions keep finding pages. Slot engines report headroom
        # 1.0, so the path never fires there.
        self.page_shed_headroom = page_shed_headroom
        self.shed_batch_priority = shed_batch_priority
        self.metrics = GatewayMetrics()
        self._uid = itertools.count()
        self._running: dict[int, _Ticket] = {}     # uid -> admitted ticket
        self._selected: list[_Ticket] = []         # picked, not prefilled
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._accepting = False
        self._stopping = False
        # latency estimators for the unmeetable-deadline shed (EMA,
        # seconds; None until warmed up — never shed on build or
        # capture time)
        self._tick_ema: Optional[float] = None
        self._admit_ema: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    @staticmethod
    def _now() -> float:
        return time.monotonic()

    async def start(self) -> "Gateway":
        if self._task is not None:
            raise RuntimeError("gateway already started")
        self._wake = asyncio.Event()
        self._accepting = True
        self._stopping = False
        self.metrics.started_t = self._now()
        self._task = asyncio.create_task(self._run(), name="gateway-tick")
        return self

    async def close(self, drain: bool = True) -> None:
        """Stop accepting new requests; with ``drain`` (default) serve
        everything already submitted first (open sessions that were
        never finalized are aborted — they could wait forever)."""
        self._accepting = False
        if self._task is None:
            return
        if not drain:
            for t in list(self._running.values()):
                self._client_abort(t, RejectCode.CANCELLED)
            while self.queue:
                t = self.queue.pop()
                if t is not None:
                    self._shed(t, RejectCode.CANCELLED, "gateway closed")
        self._stopping = True
        self._wake.set()
        await self._task
        self._task = None

    async def __aenter__(self) -> "Gateway":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close(drain=exc == (None, None, None))

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def n_running(self) -> int:
        return len(self._running)

    def report(self, kernel: str = "fp16") -> dict:
        """Metrics summary; folds in the engine's platform energy
        report (J/audio-s) when the engine has a platform, plus the
        served family's lane-state spec so a fleet of mixed-family
        gateways stays distinguishable in rolled-up metrics."""
        energy = None
        if self.engine.platform is not None:
            energy = self.engine.energy_report(kernel)
        out = self.metrics.summary(energy)
        spec = self.engine.spec
        out["engine"] = {
            "arch": self.engine.model.cfg.name,
            "family": spec.family,
            "state_kinds": list(spec.state_kinds),
            "cache_dtype": self.engine.cache_dtype,
            "prefill_exact": spec.prefill_exact,
        }
        if self.engine.spec_k:
            out["engine"]["speculative"] = {
                "spec_k": self.engine.spec_k,
                "draft_dtype": self.engine.draft_dtype,
                "acceptance_rate": self.engine.acceptance_rate,
            }
        return out

    # ------------------------------------------------------------- submit
    async def submit_tokens(self, tokens, *, max_new: int = 16,
                            eos_id: int = -1, slo: SLOClass = STANDARD,
                            timeout_s: Optional[float] = None
                            ) -> GatewayResult:
        """One-shot text request (decoder-only models): awaitable that
        resolves when the request completes, is shed, or times out."""
        req = Request(uid=next(self._uid), tokens=list(tokens),
                      max_new=max_new, eos_id=eos_id)
        return await self._submit_oneshot(req, slo, timeout_s, 0.0)

    async def submit_audio(self, frames=None, tokens=(1,), *,
                           enc_states=None, max_new: int = 16,
                           eos_id: int = -1, slo: SLOClass = INTERACTIVE,
                           timeout_s: Optional[float] = None,
                           audio_s: float = 0.0) -> GatewayResult:
        """One-shot audio request: frame embeddings (or precomputed
        encoder states) + decoder prompt. ``audio_s`` feeds the
        J/audio-s accounting."""
        req = AudioRequest(uid=next(self._uid), tokens=list(tokens),
                           max_new=max_new, eos_id=eos_id,
                           enc_frames=frames, enc_states=enc_states)
        return await self._submit_oneshot(req, slo, timeout_s, audio_s)

    async def open_session(self, tokens=(1,), *, max_new: int = 16,
                           eos_id: int = -1, slo: SLOClass = INTERACTIVE,
                           audio_s: float = 0.0) -> "StreamSession":
        """Open a streaming transcription session. The session enters
        the admission queue once its first chunk arrives (``feed``);
        its deadline counts from *now*."""
        self._check_accepting()
        ticket = self._ticket("stream", slo, audio_s)
        ticket.tokens = list(tokens)
        ticket.max_new = max_new
        ticket.eos_id = eos_id
        # mirror ServeEngine.validate's bound, speculative KV headroom
        # included, so a session the gateway accepts is never rejected
        # later at admit
        headroom = self.engine.spec_k - 1 if self.engine.spec_k else 0
        if len(ticket.tokens) + max_new + headroom >= self.engine.max_len:
            self._shed(ticket, RejectCode.TOO_LONG,
                       f"request {ticket.uid} too long for engine "
                       f"({len(ticket.tokens)}+{max_new} vs "
                       f"{self.engine.max_len})")
        return StreamSession(self, ticket)

    # ---------------------------------------------------------- internals
    def _check_accepting(self) -> None:
        if not self._accepting:
            raise RuntimeError("gateway is not accepting requests "
                               "(not started, or closing)")

    def _ticket(self, kind: str, slo: SLOClass,
                audio_s: float) -> _Ticket:
        uid = next(self._uid)
        now = self._now()
        rec = RequestRecord(uid=uid, slo=slo.name, submit_t=now,
                            deadline_t=now + slo.deadline_s,
                            audio_s=audio_s, streaming=kind == "stream")
        fut = asyncio.get_running_loop().create_future()
        return _Ticket(uid=uid, slo=slo, kind=kind, fut=fut, rec=rec)

    def _ttft_estimate(self) -> Optional[float]:
        """Expected seconds until a request submitted now gets its first
        token — queue drain time at the observed tick rate plus one
        prefill. None until both estimators warmed up (the first
        requests pay the kernels' build and the tick's capture; shedding
        on that would reject every cold-start load)."""
        if self._tick_ema is None or self._admit_ema is None:
            return None
        ticks_ahead = 1 + len(self.queue) / max(self.max_admit_per_tick, 1)
        return ticks_ahead * self._tick_ema + self._admit_ema

    @staticmethod
    def _ema(old: Optional[float], x: float, a: float = 0.3) -> float:
        return x if old is None else (1 - a) * old + a * x

    async def _submit_oneshot(self, req: Request, slo: SLOClass,
                              timeout_s: Optional[float],
                              audio_s: float) -> GatewayResult:
        self._check_accepting()
        ticket = self._ticket("oneshot", slo, audio_s)
        req.uid = ticket.uid
        ticket.req = req
        rej = self.engine.validate(req)
        if rej is not None:
            return self._shed(ticket, rej.code, str(rej))
        if not self._enqueue(ticket):
            return ticket.result
        return await self._await_ticket(ticket, timeout_s)

    def _enqueue(self, ticket: _Ticket) -> bool:
        """Shed-or-queue at admission time: unmeetable deadline first
        (reject-on-admission), then bounded-queue backpressure. False
        when shed (``ticket.result`` is set)."""
        now = self._now()
        est = self._ttft_estimate()
        if self.shed_on_submit and est is not None \
                and now + est > ticket.deadline_t:
            self._shed(ticket, RejectCode.DEADLINE_UNMEETABLE,
                       f"request {ticket.uid}: estimated TTFT "
                       f"{est:.3f}s exceeds the {ticket.slo.name} "
                       f"deadline ({ticket.deadline_t - now:.3f}s left)")
            return False
        if not self.queue.push(ticket):
            self._shed(ticket, RejectCode.QUEUE_FULL,
                       f"request {ticket.uid}: admission queue at limit "
                       f"{self.queue.limit}")
            return False
        ticket.queued = True
        self._wake.set()
        return True

    async def _await_ticket(self, ticket: _Ticket,
                            timeout_s: Optional[float]) -> GatewayResult:
        try:
            if timeout_s is None:
                return await ticket.fut
            return await asyncio.wait_for(ticket.fut, timeout_s)
        except asyncio.TimeoutError:
            return self._client_abort(ticket, RejectCode.TIMEOUT)
        except asyncio.CancelledError:
            self._client_abort(ticket, RejectCode.CANCELLED)
            raise

    # ------------------------------------------------- shed / abort / done
    def _finish(self, ticket: _Ticket, result: GatewayResult) -> None:
        ticket.done = True
        ticket.result = result
        self._running.pop(ticket.uid, None)
        self.metrics.record(ticket.rec)
        if not ticket.fut.done():
            ticket.fut.set_result(result)

    def _shed(self, ticket: _Ticket, code: RejectCode,
              message: str) -> GatewayResult:
        """Resolve a ticket as shed/rejected (never admitted, or failed
        before completion)."""
        ticket.rec.code = code
        ticket.rec.done_t = self._now()
        result = GatewayResult(uid=ticket.uid, ok=False, tokens=[],
                               partials=[], slo=ticket.slo.name,
                               code=code, error=message,
                               record=ticket.rec)
        self._finish(ticket, result)
        return result

    def _client_abort(self, ticket: _Ticket,
                      code: RejectCode) -> GatewayResult:
        """Client cancelled or timed out: free whatever the request
        holds (queue slot or engine lane) and resolve its record."""
        if ticket.done:
            return ticket.result
        ticket.cancelled = True
        if ticket.queued and ticket.state is None:
            self.queue.cancelled_dropped()   # lazy heap removal
        if ticket.state is not None:
            self.engine.abort(ticket.state, code)
        return self._shed(ticket, code,
                          f"request {ticket.uid} {code.value}")

    def _complete(self, st: RequestState) -> None:
        ticket = self._running.get(st.req.uid)
        if ticket is None or ticket.done:
            return
        now = self._now()
        ticket.rec.done_t = now
        ticket.rec.n_tokens = len(st.out)
        ticket.rec.ok = True
        if ticket.rec.first_token_t is None and st.out:
            ticket.rec.first_token_t = now
        result = GatewayResult(
            uid=ticket.uid, ok=True, tokens=list(st.out),
            partials=[list(p) for p in st.partials], slo=ticket.slo.name,
            code=None, error=None, record=ticket.rec)
        self._finish(ticket, result)

    # -------------------------------------------------------- the tick loop
    def _has_work(self) -> bool:
        return bool(len(self.queue) or self._selected or self._running
                    or self.engine.n_active)

    def _feed_streams(self) -> None:
        """Deliver one buffered chunk per open session (the real-time
        arrival model the scheduler uses), finalizing sessions whose
        audio has fully arrived."""
        for ticket in list(self._running.values()):
            if ticket.kind != "stream" or ticket.done \
                    or ticket.state is None:
                continue
            if ticket.delivered < len(ticket.chunks):
                i = ticket.delivered
                try:
                    self.engine.stream_feed(ticket.state,
                                            ticket.chunks[i])
                except RejectionError as e:
                    self.engine.abort(ticket.state, e.rejection.code,
                                      str(e))
                    self._shed(ticket, e.rejection.code, str(e))
                    continue
                ticket.delivered += 1
                now = self._now()
                ticket.rec.chunk_lags.append(now - ticket.chunk_t[i])
                if ticket.rec.first_token_t is None and ticket.state.out:
                    ticket.rec.first_token_t = now
            elif ticket.eos and not ticket.finalized:
                st = self.engine.stream_finalize(ticket.state)
                ticket.finalized = True
                if st.done:
                    self._complete(st)

    def _select_admissions(self) -> None:
        """The overlap-window half of admission: pop the EDF queue while
        free slots remain, shedding entries whose deadline has already
        passed (**before** any prefill is spent on them). Selected
        tickets prefill at the next tick boundary."""
        now = self._now()
        headroom = self.engine.page_headroom()
        if headroom < self.page_shed_headroom and len(self.queue):
            # page pool nearly dry: shed batch-class backlog first, so
            # the pages that do drain go to interactive work
            for t in self.queue.shed_class(self.shed_batch_priority):
                self._shed(t, RejectCode.POOL_EXHAUSTED,
                           f"request {t.uid}: page pool low (headroom "
                           f"{headroom:.2f} < {self.page_shed_headroom}"
                           f") — {t.slo.name}-class work shed")
        budget = min(self.max_admit_per_tick,
                     len(self.engine.free)) - len(self._selected)
        while budget > 0:
            ticket = self.queue.pop()
            if ticket is None:
                break
            if now > ticket.deadline_t:
                self._shed(ticket, RejectCode.DEADLINE_MISSED,
                           f"request {ticket.uid}: deadline passed "
                           f"{now - ticket.deadline_t:.3f}s before "
                           f"prefill — shed unstarted")
                continue
            self._selected.append(ticket)
            budget -= 1

    def _prefill_selected(self) -> None:
        """The tick-boundary half of admission: run the engine prefill
        (one scalar host sync each) for the tickets picked during the
        previous overlap window."""
        pending, self._selected = self._selected, []
        for ticket in pending:
            if ticket.cancelled or ticket.done:
                continue
            t0 = self._now()
            try:
                if ticket.kind == "stream":
                    req = StreamingAudioRequest(
                        uid=ticket.uid, tokens=list(ticket.tokens),
                        max_new=ticket.max_new, eos_id=ticket.eos_id,
                        chunks=ticket.chunks)
                    st = self.engine.open_stream(req)
                else:
                    st = self.engine.admit(ticket.req)
            except RejectionError as e:
                self._shed(ticket, e.rejection.code, str(e))
                continue
            if st is None:                 # pool filled after selection
                self.queue.push(ticket)
                continue
            ticket.state = st
            ticket.rec.admit_t = t0
            self._running[ticket.uid] = ticket
            if ticket.kind == "stream":
                # anchor against the first chunk immediately (the
                # scheduler does the same at admission)
                self.engine.stream_feed(st, ticket.chunks[0])
                ticket.delivered = 1
                now = self._now()
                ticket.rec.chunk_lags.append(now - ticket.chunk_t[0])
                if st.out:
                    ticket.rec.first_token_t = now
            else:
                ticket.rec.first_token_t = self._now()
            self._admit_ema = self._ema(self._admit_ema,
                                        self._now() - t0)
            if ticket.kind == "oneshot" and st.done:
                self._complete(st)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._feed_streams()
                self._prefill_selected()
                pending = self.engine.step_begin()
                if pending is None:
                    # no lane decoding: admit immediately, else sleep
                    # until a submit/feed wakes us (bounded, so paused
                    # streams and close() are re-checked)
                    self._select_admissions()
                    if self._selected:
                        continue
                    if self._stopping and not self._has_work():
                        break
                    if self._stopping:
                        self._abort_unfinalized()
                        continue
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               self.idle_wait_s)
                    except asyncio.TimeoutError:
                        pass
                    continue
                t0 = self._now()
                # ---- overlap window: the device is running this tick.
                # Pick next tick's admissions, shed expired work, and
                # yield so client coroutines submit/cancel/feed.
                self._select_admissions()
                await asyncio.sleep(0)
                # THE host sync — in an executor so the event loop (and
                # every client) stays live during the device wait.
                tok_blk, emit_blk = await loop.run_in_executor(
                    None, self.engine.step_fetch, pending)
                finished = self.engine.step_replay(pending, tok_blk,
                                                   emit_blk)
                self._tick_ema = self._ema(self._tick_ema,
                                           self._now() - t0)
                self.metrics.ticks += 1
                for st in finished:
                    self._complete(st)
                await asyncio.sleep(0)     # let clients see results
        finally:
            self.metrics.stopped_t = self._now()

    def _abort_unfinalized(self) -> None:
        """Closing: sessions that were never finalized would wait for
        audio forever — abort them so ``close(drain=True)`` terminates."""
        for ticket in list(self._running.values()):
            stuck = ticket.kind == "stream" and not ticket.eos \
                and ticket.delivered >= len(ticket.chunks)
            if stuck:
                self._client_abort(ticket, RejectCode.CANCELLED)

    def _session_fail(self, ticket: _Ticket, code: RejectCode,
                      message: str) -> None:
        """A feed-side validation failure sheds the whole session: abort
        the engine lane if one is held, drop the queue entry, resolve."""
        if ticket.done:
            return
        if ticket.state is not None:
            self.engine.abort(ticket.state, code, message)
        elif ticket.queued:
            ticket.cancelled = True
            self.queue.cancelled_dropped()
        self._shed(ticket, code, message)


class StreamSession:
    """Client handle for one streaming transcription: ``feed`` audio
    chunks as they arrive, ``finalize`` to close the audio and await
    the transcript. Mirrors ``StreamingAudioRequest`` semantics — the
    final tokens are identical to one-shot serving of the same audio."""

    def __init__(self, gw: Gateway, ticket: _Ticket):
        self._gw = gw
        self._ticket = ticket

    @property
    def uid(self) -> int:
        return self._ticket.uid

    @property
    def partials(self) -> list:
        st = self._ticket.state
        return [list(p) for p in st.partials] if st is not None else []

    @property
    def done(self) -> bool:
        return self._ticket.done

    async def feed(self, frames) -> None:
        """Buffer one chunk of frame embeddings ``(s, d_model)`` (an
        array, or a tensor kept as given); the tick loop delivers one
        chunk per tick. The session enters the admission queue at the
        first feed. Misshapen or overflowing chunks shed the whole
        session (``finalize`` returns the shed result)."""
        gw, ticket = self._gw, self._ticket
        if ticket.done:
            return
        if ticket.eos:
            raise RuntimeError(f"session {ticket.uid}: feed after "
                               f"finalize")
        shp = np.shape(frames)
        d_model = gw.engine.model.cfg.d_model
        if len(shp) != 2 or shp[1] != d_model or shp[0] < 1:
            gw._session_fail(ticket, RejectCode.BAD_ENC_SHAPE,
                             f"session {ticket.uid}: chunk must be "
                             f"(s, {d_model}) with s >= 1, got {shp}")
            return
        total = sum(np.shape(c)[0] for c in ticket.chunks) + shp[0]
        if total > gw.engine.enc_len:
            gw._session_fail(ticket, RejectCode.ENC_OVERFLOW,
                             f"session {ticket.uid}: {total} streamed "
                             f"frames exceed the pool enc_len "
                             f"{gw.engine.enc_len}")
            return
        ticket.chunks.append(frames if isinstance(frames, torch.Tensor)
                             else np.asarray(frames, np.float32))
        ticket.chunk_t.append(gw._now())
        if not ticket.queued:
            gw._enqueue(ticket)
        else:
            gw._wake.set()
        await asyncio.sleep(0)             # let the tick loop run

    async def finalize(self, timeout_s: Optional[float] = None
                       ) -> GatewayResult:
        """End of audio: await the final transcript (the engine
        re-anchors, so it is token-identical to one-shot serving)."""
        gw, ticket = self._gw, self._ticket
        if ticket.done:
            return ticket.result
        if not ticket.chunks:
            return gw._shed(ticket, RejectCode.MISSING_ENC_INPUT,
                            f"session {ticket.uid}: finalized with no "
                            f"audio")
        ticket.eos = True
        gw._wake.set()
        return await gw._await_ticket(ticket, timeout_s)

    async def cancel(self) -> GatewayResult:
        """Client-side abort: frees the lane/queue slot immediately."""
        return self._gw._client_abort(self._ticket, RejectCode.CANCELLED)
