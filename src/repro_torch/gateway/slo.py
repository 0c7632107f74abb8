"""SLO classes and the prioritized admission queue (the JAX package's
``gateway/slo.py``).

An ``SLOClass`` names a service tier: a priority (lower = served
first) and an end-to-end deadline budget counted from submit. The
``AdmissionQueue`` replaces the scheduler's FCFS deque with
**earliest-deadline-first within priority class**: all queued
interactive requests outrank all standard ones, and within a class the
request whose deadline expires soonest is admitted first (ties broken
by submit order). The queue is bounded — a full queue is backpressure,
and the gateway sheds the submit with ``RejectCode.QUEUE_FULL``
instead of growing an unbounded backlog.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service tier: admission priority + end-to-end deadline.

    ``priority``: lower value = admitted first (class-strict).
    ``deadline_s``: seconds from submit within which the request must
    complete to count toward goodput; also the shed threshold.
    """

    name: str
    priority: int
    deadline_s: float

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(
                f"SLO {self.name!r}: deadline_s must be > 0, got "
                f"{self.deadline_s}")


# The default tiers. Deadlines are generous for CPU test runs (reduced
# and micro models on shared runners); deployments define their own.
INTERACTIVE = SLOClass("interactive", priority=0, deadline_s=15.0)
STANDARD = SLOClass("standard", priority=1, deadline_s=60.0)
BATCH = SLOClass("batch", priority=2, deadline_s=600.0)

DEFAULT_CLASSES = (INTERACTIVE, STANDARD, BATCH)


class AdmissionQueue:
    """Bounded EDF-within-priority admission queue.

    Entries are gateway tickets (anything with ``.slo`` and
    ``.deadline_t``); ordering key is ``(priority, deadline_t, seq)``.
    ``push`` returns False when the queue is full (the caller sheds);
    cancelled tickets are removed lazily at ``pop`` (``ticket.cancelled``
    truthy), so client-side aborts cost O(1).
    """

    def __init__(self, limit: int = 64):
        if limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {limit}")
        self.limit = limit
        self._heap: list = []
        self._seq = itertools.count()
        self._live = 0          # pushed minus popped/cancelled-at-pop

    def __len__(self) -> int:
        return self._live

    @property
    def full(self) -> bool:
        return self._live >= self.limit

    def push(self, ticket) -> bool:
        """Enqueue; False (backpressure) when the queue is at limit."""
        if self.full:
            return False
        heapq.heappush(self._heap,
                       (ticket.slo.priority, ticket.deadline_t,
                        next(self._seq), ticket))
        self._live += 1
        return True

    def cancelled_dropped(self, n: int = 1) -> None:
        """Account a queued ticket cancelled in place (it stays in the
        heap until popped, but no longer occupies a live slot)."""
        self._live = max(0, self._live - n)

    def pop(self):
        """Highest-priority, earliest-deadline live ticket; None when
        empty. Skips (and discards) cancelled tickets."""
        while self._heap:
            *_, ticket = heapq.heappop(self._heap)
            if getattr(ticket, "cancelled", False):
                continue
            self._live -= 1
            return ticket
        self._live = 0
        return None

    def shed_class(self, min_priority: int) -> list:
        """Remove and return every live ticket at or below service tier
        ``min_priority`` (higher value = lower priority; BATCH is 2).

        The load-shed hook: when the engine's page pool runs low, the
        gateway drops queued batch-class work first so interactive
        admissions keep finding pages. Cancelled tickets are discarded
        (they were already resolved, and sweeping them here settles the
        lazy-removal debt); the heap is rebuilt from the survivors."""
        keep, shed = [], []
        for entry in self._heap:
            ticket = entry[-1]
            if getattr(ticket, "cancelled", False):
                continue
            if ticket.slo.priority >= min_priority:
                shed.append(ticket)
            else:
                keep.append(entry)
        heapq.heapify(keep)
        self._heap = keep
        self._live = len(keep)
        return shed

    def peek(self):
        """The ticket ``pop`` would return, without removing it."""
        while self._heap:
            *_, ticket = self._heap[0]
            if getattr(ticket, "cancelled", False):
                heapq.heappop(self._heap)
                continue
            return ticket
        return None
