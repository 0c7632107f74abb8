"""Refcounted fixed-size page pool with a LIFO free list.

One ``PagePool`` manages the physical pages of one cache plane family
(self-KV or cross-KV). Page 0 is the reserved *scratch* page: it is
never handed out by ``alloc`` and every cleared page-table row points at
it, so in-flight device writes from frozen or just-freed lanes land in
scratch instead of corrupting a page that may already belong to another
lane. Exhaustion raises :class:`PageAllocError` — callers convert it to
an admission ``Rejection`` (``RejectCode.POOL_EXHAUSTED``); it is never
an assert, because running out of pages is a load condition, not a bug.

Shared (copy-on-write) pages are expressed through per-page refcounts:
``retain`` bumps, ``free`` drops, and the page returns to the free list
only at refcount zero. ``on_free`` callbacks let the prefix store evict
its index entry when the last lane holding a shared page drains.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.paging.table import SCRATCH_PAGE


class PageAllocError(Exception):
    """Page pool exhausted (transient, load-dependent — not a bug)."""

    def __init__(self, pool: str, requested: int, free: int):
        self.pool = pool
        self.requested = requested
        self.free = free
        super().__init__(
            f"page pool '{pool}' exhausted: requested {requested} pages, "
            f"{free} free")


class PagePool:
    """Free-list allocator over pages ``1..n_pages-1`` (0 = scratch)."""

    def __init__(self, n_pages: int, page_size: int, *, name: str = "kv"):
        if n_pages < 2:
            raise ValueError(
                f"pool '{name}' needs >= 2 pages (1 scratch + 1 usable), "
                f"got {n_pages}")
        self.name = name
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list: low page ids come back first, which keeps the
        # working set compact and makes tests deterministic.
        self._free = list(range(n_pages - 1, 0, -1))
        self._ref = [0] * n_pages
        self._on_free: dict[int, Callable[[int], None]] = {}

    # ---- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Distinct physical pages currently allocated (excl. scratch)."""
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def can_alloc(self, k: int) -> bool:
        return k <= len(self._free)

    # ---- alloc / retain / free --------------------------------------------
    def alloc(self, k: int) -> list[int]:
        """Allocate ``k`` pages at refcount 1; raises PageAllocError."""
        if k < 0:
            raise ValueError(f"alloc({k})")
        if k > len(self._free):
            raise PageAllocError(self.name, k, len(self._free))
        pages = [self._free.pop() for _ in range(k)]
        for pg in pages:
            self._ref[pg] = 1
        return pages

    def try_alloc(self, k: int) -> Optional[list[int]]:
        """Like ``alloc`` but returns None instead of raising."""
        if k > len(self._free):
            return None
        return self.alloc(k)

    def retain(self, page: int) -> int:
        """Add a reference to an allocated page (COW sharing)."""
        if page == SCRATCH_PAGE:
            return 0   # scratch is unowned; sharing it is a no-op
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"pool '{self.name}': retain of unallocated page {page}")
        self._ref[page] += 1
        return self._ref[page]

    def free(self, page: int) -> int:
        """Drop one reference; the page returns to the free list at zero.
        Returns the remaining refcount. Double-free raises."""
        if page == SCRATCH_PAGE:
            return 0
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"pool '{self.name}': double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            cb = self._on_free.pop(page, None)
            if cb is not None:
                cb(page)
            self._free.append(page)
        return self._ref[page]

    def free_all(self, pages: list[int]) -> None:
        for pg in pages:
            self.free(pg)

    def set_on_free(self, page: int, cb: Callable[[int], None]) -> None:
        """Run ``cb(page)`` when ``page``'s refcount reaches zero (used by
        the prefix store to evict its index entry)."""
        self._on_free[page] = cb

    # ---- invariant checks (tests) -----------------------------------------
    def check(self) -> None:
        """Structural invariants: every page is either free (ref 0) or
        allocated (ref > 0); no duplicates in the free list."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError(f"pool '{self.name}': duplicate free pages")
        free = set(self._free)
        if SCRATCH_PAGE in free:
            raise AssertionError(f"pool '{self.name}': scratch in free list")
        for pg in range(1, self.n_pages):
            if (pg in free) != (self._ref[pg] == 0):
                raise AssertionError(
                    f"pool '{self.name}': page {pg} ref={self._ref[pg]} "
                    f"free={pg in free}")
