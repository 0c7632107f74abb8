"""Per-lane page tables: logical cache position -> (page, offset).

Row ``b`` maps lane ``b``'s logical page ``i`` to a physical page id in
the pool's plane tensors; logical position ``t`` lives at
``(table[b, t // P], t % P)``. Cleared rows point every entry at the
scratch page (0), so a freed lane's in-flight device writes can never
corrupt a page that has been handed to another lane.

The host keeps a plain nested-list mirror (the reference's
``paging/table.py``). The device side is one ``(n_slots, n_logical)``
int64 tensor, made once: the engine's captured decode tick reads it by
address, so nothing ever rebinds it. A mutation writes the changed row
into it in place, with one asynchronous host-to-device copy, ordered on
the current stream before any later tick.
"""

from __future__ import annotations

import torch

SCRATCH_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    """ceil(n_tokens / page_size)."""
    return -(-n_tokens // page_size)


class PageTable:
    """Host mirror + persistent device tensor of per-lane page mappings."""

    def __init__(self, n_slots: int, max_len: int, page_size: int,
                 device=None):
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} not a multiple of page_size {page_size}")
        self.n_slots = n_slots
        self.page_size = page_size
        self.n_logical = max_len // page_size
        self._rows = [[SCRATCH_PAGE] * self.n_logical
                      for _ in range(n_slots)]
        self._device = torch.full((n_slots, self.n_logical), SCRATCH_PAGE,
                                  dtype=torch.int64,
                                  device=torch.device(device or "cpu"))
        self._version = 0

    # ---- mutation ---------------------------------------------------------
    def set_row(self, slot: int, pages: list[int]) -> None:
        """Map lane ``slot``'s logical pages [0, len(pages)) to ``pages``;
        the tail keeps pointing at scratch."""
        if len(pages) > self.n_logical:
            raise ValueError(
                f"{len(pages)} pages > {self.n_logical} logical slots")
        row = [SCRATCH_PAGE] * self.n_logical
        row[:len(pages)] = pages
        self._rows[slot] = row
        self._dirty(slot)

    def set_entry(self, slot: int, logical: int, page: int) -> None:
        self._rows[slot][logical] = page
        self._dirty(slot)

    def extend_row(self, slot: int, start_logical: int,
                   pages: list[int]) -> None:
        """Map logical pages [start_logical, start_logical+len) in place."""
        row = self._rows[slot]
        for i, pg in enumerate(pages):
            row[start_logical + i] = pg
        self._dirty(slot)

    def clear_row(self, slot: int) -> None:
        self._rows[slot] = [SCRATCH_PAGE] * self.n_logical
        self._dirty(slot)

    def _dirty(self, slot: int) -> None:
        """Write row ``slot`` of the mirror into the device tensor: one
        asynchronous copy (a Python scalar written into a CUDA tensor
        would wait on the device)."""
        row = torch.tensor(self._rows[slot], dtype=torch.int64)
        self._device[slot] = row.to(self._device.device, non_blocking=True)
        self._version += 1

    # ---- queries ----------------------------------------------------------
    def row(self, slot: int) -> list[int]:
        return list(self._rows[slot])

    def entry(self, slot: int, logical: int) -> int:
        return self._rows[slot][logical]

    def lookup(self, slot: int, position: int) -> tuple[int, int]:
        """Logical position -> (physical page, offset within page)."""
        return (self._rows[slot][position // self.page_size],
                position % self.page_size)

    @property
    def version(self) -> int:
        """Bumped on every row mutation."""
        return self._version

    def device(self) -> torch.Tensor:
        """The (n_slots, n_logical) int64 device table: the same tensor
        for the table's life, updated in place."""
        return self._device
