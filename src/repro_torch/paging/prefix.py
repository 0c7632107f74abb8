"""Hash-keyed prefix blocks with copy-on-write refcounting.

Whisper decoding starts every lane with the same ``<sot><lang><task>``
anchor tokens, and serving replays the same audio clip across lanes in
benchmarks — so the first page(s) of the self-KV cache (and the whole
cross-KV block) are byte-identical across lanes. The store indexes those
*full* prompt pages by content key and hands the same physical pages to
every matching lane, bumping pool refcounts instead of copying.

Key design points:

- Self-KV prefix pages are keyed by ``(prompt tokens, encoder digest)``:
  decoder self-K/V at layers >= 1 flows through cross-attention over the
  encoder states, so identical tokens over *different* audio produce
  different K/V — the digest is mandatory for correctness.
- Cross-KV pages are keyed by the encoder digest alone (they depend only
  on the encoder states).
- Only FULL pages are shared (``m_pages = n // P``): a partially filled
  final prompt page will be appended to by decode, which would diverge
  the shared copy. Decode's first write lands at logical page ``n // P``
  — always a private page.
- The store holds no references of its own: entries are evicted via the
  pool's ``on_free`` callback when the last holding lane drains, so
  the index can never pin pages.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

from repro_torch.paging.allocator import PagePool


def content_digest(*parts: bytes) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p)
    return h.hexdigest()


@dataclasses.dataclass
class PrefixEntry:
    key: tuple
    pages: list[int]     # physical pages, in logical order


class PrefixStore:
    """Content-addressed index of shared prefix pages over one pool."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: dict[tuple, PrefixEntry] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple) -> Optional[list[int]]:
        """If ``key`` is indexed, retain its pages for the caller and
        return them; otherwise record a miss and return None."""
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        for pg in ent.pages:
            self.pool.retain(pg)
        return list(ent.pages)

    def publish(self, key: tuple, pages: list[int]) -> None:
        """Index ``pages`` (already owned by the publishing lane) under
        ``key``. The store takes no reference; when the first page's
        refcount hits zero the whole entry is evicted."""
        if not pages or key in self._entries:
            return
        ent = PrefixEntry(key=key, pages=list(pages))
        self._entries[key] = ent
        self.pool.set_on_free(pages[0], lambda _pg, k=key: self.evict(k))

    def evict(self, key: tuple) -> None:
        self._entries.pop(key, None)

    def max_refcount(self) -> int:
        """Highest refcount across indexed pages (capacity-point check:
        == number of lanes sharing the anchor prompt)."""
        best = 0
        for ent in self._entries.values():
            for pg in ent.pages:
                best = max(best, self.pool.refcount(pg))
        return best

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "max_refcount": self.max_refcount()}
