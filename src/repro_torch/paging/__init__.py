"""Paged KV/cross-KV cache subsystem (host-side bookkeeping), the port of
the reference's ``paging/`` package.

A page pool turns the serving engine's capacity limit from
``n_slots x max_len`` padding into actual token bytes: each lane maps
logical cache positions to fixed-size physical pages through a per-lane
page table, pages are allocated from a refcounted free list, and
identical prompt prefixes (Whisper's ``<sot><lang><task>`` anchor) and
identical audio share physical pages copy-on-write across lanes.

Everything here but the tables' device tensors is plain Python; the
device read and write paths live in ``repro_torch.models.attention``
(writes through the table) and the ``paged_decode_attention`` op.
"""

from repro_torch.paging.allocator import PageAllocError, PagePool
from repro_torch.paging.manager import LanePages, PagedKV
from repro_torch.paging.prefix import PrefixEntry, PrefixStore, content_digest
from repro_torch.paging.table import SCRATCH_PAGE, PageTable, pages_needed

__all__ = sorted([
    "LanePages",
    "PageAllocError",
    "PagePool",
    "PageTable",
    "PagedKV",
    "PrefixEntry",
    "PrefixStore",
    "SCRATCH_PAGE",
    "content_digest",
    "pages_needed",
])
