"""Lane-level orchestration over page pools, tables, and prefix store
(the reference's ``paging/manager.py``).

``PagedKV`` is the one object the serving engine talks to. It owns:

- a self-KV pool + table (``max_len // P`` logical pages per lane) and a
  cross-KV pool + table (``enc_len // P`` logical pages per lane);
- a :class:`PrefixStore` per pool — self prefixes keyed by
  ``(prompt tokens, encoder digest)``, cross blocks by the digest alone;
- per-lane ownership records (:class:`LanePages`) so freeing a lane
  releases exactly the references it holds.

Admission allocates a lane's full extent up front —
``ceil((n + max_new) / P)`` self pages and ``ceil(enc_s / P)`` cross
pages — so decode never allocates mid-tick (no new host work on the hot
path, the one-host-sync-per-tick invariant is untouched) and a frozen
lane re-writing its last position always lands on an owned page.
Transient exhaustion raises :class:`PageAllocError` with any partial
allocation rolled back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.paging.allocator import PageAllocError, PagePool
from repro_torch.paging.prefix import PrefixStore
from repro_torch.paging.table import PageTable, pages_needed


@dataclasses.dataclass
class LanePages:
    slot: int
    self_pages: list[int]          # owned refs, logical order
    cross_pages: list[int]
    self_shared: int               # leading self pages from the store
    cross_shared: int
    self_len: int = 0              # valid tokens (engine-updated)
    cross_len: int = 0             # valid encoder frames


class PagedKV:
    def __init__(self, *, n_slots: int, max_len: int, enc_len: int,
                 page_size: int, n_pages: int, n_cross_pages: int,
                 device=None):
        """``device``: where the two page tables' device tensors live
        (the engine's; default the CPU)."""
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.self_pool = PagePool(n_pages, page_size, name="self")
        self.cross_pool = PagePool(n_cross_pages, page_size, name="cross")
        self.self_table = PageTable(n_slots, max_len, page_size, device)
        self.cross_table = PageTable(n_slots, enc_len, page_size, device)
        self.self_prefix = PrefixStore(self.self_pool)
        self.cross_prefix = PrefixStore(self.cross_pool)
        self.lanes: dict[int, LanePages] = {}

    # ---- capacity ---------------------------------------------------------
    def pages_for_request(self, n_tokens: int, max_new: int,
                          enc_s: int) -> tuple[int, int]:
        """Worst-case (self, cross) page demand of a request, ignoring
        prefix sharing (admission prechecks use this lower bound on
        availability conservatively... the shared-prefix discount only
        ever *reduces* the real demand)."""
        return (pages_needed(n_tokens + max_new, self.page_size),
                pages_needed(enc_s, self.page_size))

    def can_admit(self, n_tokens: int, max_new: int, enc_s: int) -> bool:
        n_self, n_cross = self.pages_for_request(n_tokens, max_new, enc_s)
        return (self.self_pool.can_alloc(n_self)
                and self.cross_pool.can_alloc(n_cross))

    def fits(self, n_tokens: int, max_new: int, enc_s: int) -> bool:
        """Could this request EVER fit (empty pool)? Permanent check."""
        n_self, n_cross = self.pages_for_request(n_tokens, max_new, enc_s)
        return (n_self <= self.self_pool.n_pages - 1
                and n_cross <= self.cross_pool.n_pages - 1)

    # ---- admission --------------------------------------------------------
    def admit_lane(self, slot: int, tokens, enc_digest: str, *,
                   max_new: int, enc_s: int) -> LanePages:
        """Allocate a lane's pages, sharing full prompt pages and cross
        blocks by content. Raises :class:`PageAllocError` (rolled back)
        on exhaustion. ``tokens``: the prompt token ids (list/sequence).
        """
        p = self.page_size
        n = len(tokens)
        total_self = pages_needed(n + max_new, p)
        m_shared = n // p      # only FULL prompt pages are shareable
        self_key = (tuple(int(t) for t in tokens[:m_shared * p]),
                    enc_digest)
        cross_key = (enc_digest, enc_s)

        self_pages: list[int] = []
        shared_n = 0
        if m_shared > 0:
            hit = self.self_prefix.lookup(self_key)
            if hit is not None:
                self_pages = hit
                shared_n = len(hit)
        cross_pages: list[int] = []
        cross_shared = 0
        n_cross = pages_needed(enc_s, p)
        hit_c = self.cross_prefix.lookup(cross_key) if enc_s else None
        if hit_c is not None:
            cross_pages = hit_c
            cross_shared = len(hit_c)

        try:
            priv = self.self_pool.alloc(total_self - shared_n)
            self_pages = self_pages + priv
            if cross_shared == 0 and n_cross:
                try:
                    cross_pages = self.cross_pool.alloc(n_cross)
                except PageAllocError:
                    self.self_pool.free_all(self_pages)
                    raise
        except PageAllocError:
            if shared_n:
                self.self_pool.free_all(self_pages[:shared_n])
            if cross_shared:
                self.cross_pool.free_all(cross_pages)
            raise

        self.self_table.set_row(slot, self_pages)
        self.cross_table.set_row(slot, cross_pages)
        lane = LanePages(slot=slot, self_pages=self_pages,
                         cross_pages=cross_pages, self_shared=shared_n,
                         cross_shared=cross_shared, self_len=n,
                         cross_len=enc_s)
        self.lanes[slot] = lane
        # publish what wasn't already indexed (the first lane with this
        # content becomes the donor; the store holds no refs of its own)
        if m_shared > 0 and shared_n == 0:
            self.self_prefix.publish(self_key, self_pages[:m_shared])
        if n_cross and cross_shared == 0:
            self.cross_prefix.publish(cross_key, cross_pages)
        return lane

    def admit_stream_lane(self, slot: int) -> LanePages:
        """Open a streaming lane: cross pages arrive via ``extend_cross``
        and self pages via ``alloc_self`` at finalize. Never shared."""
        lane = LanePages(slot=slot, self_pages=[], cross_pages=[],
                         self_shared=0, cross_shared=0)
        self.lanes[slot] = lane
        self.self_table.clear_row(slot)
        self.cross_table.clear_row(slot)
        return lane

    def alloc_self(self, slot: int, n_tokens: int, max_new: int) -> LanePages:
        """Allocate a streaming lane's self pages once the prompt length
        is known (finalize). Raises on exhaustion (nothing to roll back:
        cross pages stay owned; the caller decides the lane's fate)."""
        lane = self.lanes[slot]
        total = pages_needed(n_tokens + max_new, self.page_size)
        lane.self_pages = self.self_pool.alloc(total)
        lane.self_len = n_tokens
        self.self_table.set_row(slot, lane.self_pages)
        return lane

    def extend_cross(self, slot: int, offset: int, s_new: int):
        """Grow a streaming lane's cross block to cover frames
        [offset, offset + s_new). Returns (phys, off) int lists for those
        positions — the device extend-write's gather targets. Raises
        :class:`PageAllocError` if the pool can't supply the new pages
        (the lane keeps what it had)."""
        p = self.page_size
        lane = self.lanes[slot]
        have = len(lane.cross_pages)
        need = pages_needed(offset + s_new, p)
        if need > have:
            new = self.cross_pool.alloc(need - have)   # raises; no change
            self.cross_table.extend_row(slot, have, new)
            lane.cross_pages = lane.cross_pages + new
        lane.cross_len = offset + s_new
        phys = [lane.cross_pages[(offset + i) // p] for i in range(s_new)]
        off = [(offset + i) % p for i in range(s_new)]
        return phys, off

    # ---- copy-on-write ----------------------------------------------------
    def ensure_writable(self, slot: int, logical: int, *,
                        kind: str = "self",
                        copier: Optional[Callable[[int, int], None]] = None
                        ) -> Optional[tuple[int, int]]:
        """Guarantee lane ``slot`` exclusively owns its ``logical`` page.

        If the page is shared (refcount > 1), allocate a private page,
        call ``copier(old, new)`` to clone the content, repoint the
        lane's table entry, and drop the shared ref. Returns
        ``(old, new)`` when a clone happened, None when the lane already
        owned the page. Raises :class:`PageAllocError` when no page is
        free for the clone."""
        pool = self.self_pool if kind == "self" else self.cross_pool
        table = self.self_table if kind == "self" else self.cross_table
        lane = self.lanes[slot]
        pages = lane.self_pages if kind == "self" else lane.cross_pages
        old = pages[logical]
        if pool.refcount(old) <= 1:
            return None
        new = pool.alloc(1)[0]
        if copier is not None:
            copier(old, new)
        pages[logical] = new
        table.set_entry(slot, logical, new)
        if kind == "self" and logical < lane.self_shared:
            lane.self_shared = min(lane.self_shared, logical)
        if kind == "cross" and logical < lane.cross_shared:
            lane.cross_shared = min(lane.cross_shared, logical)
        pool.free(old)
        return old, new

    # ---- release ----------------------------------------------------------
    def free_lane(self, slot: int) -> None:
        lane = self.lanes.pop(slot, None)
        if lane is None:
            return
        self.self_pool.free_all(lane.self_pages)
        self.cross_pool.free_all(lane.cross_pages)
        self.self_table.clear_row(slot)
        self.cross_table.clear_row(slot)

    def note_len(self, slot: int, self_len: int) -> None:
        lane = self.lanes.get(slot)
        if lane is not None:
            lane.self_len = self_len

    # ---- accounting -------------------------------------------------------
    def _pool_report(self, pool: PagePool, pick) -> dict:
        p = self.page_size
        fill: dict[int, int] = {}
        for lane in self.lanes.values():
            pages, n_tok = pick(lane)
            for i, pg in enumerate(pages):
                f = max(0, min(p, n_tok - i * p))
                fill[pg] = max(fill.get(pg, 0), f)
        used = pool.used_pages
        used_tokens = sum(fill.values())
        frag = 1.0 - used_tokens / (used * p) if used else 0.0
        return {"n_pages": pool.n_pages, "page_size": p,
                "pages_in_use": used, "pages_free": pool.free_pages,
                "resident_tokens": used_tokens,
                "fragmentation": frag}

    def report(self) -> dict:
        return {
            "page_size": self.page_size,
            "self": self._pool_report(
                self.self_pool, lambda ln: (ln.self_pages, ln.self_len)),
            "cross": self._pool_report(
                self.cross_pool, lambda ln: (ln.cross_pages, ln.cross_len)),
            "prefix": {"self": self.self_prefix.stats(),
                       "cross": self.cross_prefix.stats()},
            "resident_lanes": len(self.lanes),
        }

    def check(self) -> None:
        self.self_pool.check()
        self.cross_pool.check()
