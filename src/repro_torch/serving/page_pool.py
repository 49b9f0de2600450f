"""Block-table page pool for the paged KV/latent cache: a copy of
``repro/serving/page_pool.py`` (numpy/stdlib only), kept in step with it
by ``tests/test_torch_copies.py``.

The pool owns a fixed budget of ``num_pages`` pages of ``page_size``
tokens each and hands them out to sequences on demand: a sequence's
tokens ``[0, L)`` live at logical slots — token ``t`` in page
``block_table[t // page_size]``, offset ``t % page_size`` — so per-
sequence cache footprint is ``ceil(L / page_size)`` pages instead of a
dense ``max_len`` reservation.  That is the whole concurrency lever:
at fixed cache HBM a replica admits as many sequences as *actual*
tokens fit, not as many worst-case reservations fit.

Bookkeeping is numpy/stdlib-only (the page *tensors* live in the
engine; the pool only manages page ids).  Allocation is a FIFO free
list — deterministic, O(1) per page — and every mutation keeps three
invariants the property tests pin:

  * no double allocation: a page id is in at most one block table,
    and never both allocated and free;
  * conservation: ``free_pages + allocated_pages == num_pages``;
  * block-table consistency: ``len(block_table(seq)) ==
    pages_for(length(seq))`` after any admit/extend/release churn.

Occupancy and internal fragmentation (allocated-but-unused token
slack) are exposed as telemetry gauges when a :class:`Telemetry`
facade is attached.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Set

from repro_torch.telemetry import Telemetry, maybe as _maybe_tel


class PagesExhausted(RuntimeError):
    """Raised when an allocation/extension exceeds the free-page budget."""


class PagePool:
    def __init__(self, num_pages: int, page_size: int,
                 telemetry: Optional[Telemetry] = None):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: Deque[int] = deque(range(num_pages))
        self._free_set: Set[int] = set(range(num_pages))
        self._tables: Dict[int, List[int]] = {}     # seq -> page ids
        self._lengths: Dict[int, int] = {}          # seq -> token count
        self._tel = _maybe_tel(telemetry)
        self._publish()

    # -- sizing -------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens (>= 1 token -> >= 1
        page; 0 tokens -> 0 pages)."""
        return -(-max(int(n_tokens), 0) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of the page budget currently allocated."""
        return self.allocated_pages / self.num_pages

    @property
    def internal_fragmentation(self) -> float:
        """Allocated-but-unused token slack: 1 - used/capacity over the
        allocated pages (0.0 when nothing is allocated)."""
        cap = self.allocated_pages * self.page_size
        if cap == 0:
            return 0.0
        used = sum(self._lengths.values())
        return 1.0 - used / cap

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    # -- sequence lifecycle -------------------------------------------------

    def allocate(self, seq: int, n_tokens: int) -> List[int]:
        """Open ``seq`` with pages for ``n_tokens`` tokens.  Returns the
        block table (page ids in logical order)."""
        if seq in self._tables:
            raise ValueError(f"sequence {seq} already has an allocation")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            raise PagesExhausted(
                f"need {need} pages for {n_tokens} tokens, "
                f"{len(self._free)} free")
        table = [self._take() for _ in range(need)]
        self._tables[seq] = table
        self._lengths[seq] = int(n_tokens)
        self._publish()
        return list(table)

    def extend(self, seq: int, n_tokens: int) -> List[int]:
        """Grow ``seq`` to ``n_tokens`` *total* tokens, allocating pages
        as logical length crosses page boundaries.  Returns the newly
        allocated page ids (often empty: within-page growth is free)."""
        table = self._tables.get(seq)
        if table is None:
            raise KeyError(f"sequence {seq} has no allocation")
        if n_tokens < self._lengths[seq]:
            raise ValueError("extend cannot shrink a sequence")
        need = self.pages_for(n_tokens) - len(table)
        if need > len(self._free):
            raise PagesExhausted(
                f"need {need} more pages for sequence {seq}, "
                f"{len(self._free)} free")
        new = [self._take() for _ in range(need)]
        table.extend(new)
        self._lengths[seq] = int(n_tokens)
        self._publish()
        return new

    def release(self, seq: int) -> int:
        """Return ``seq``'s pages to the free list.  Raises ``KeyError``
        on double release.  Returns the number of pages freed."""
        table = self._tables.pop(seq)       # KeyError on double release
        del self._lengths[seq]
        for pid in table:
            self._free.append(pid)
            self._free_set.add(pid)
        self._publish()
        return len(table)

    # -- views --------------------------------------------------------------

    def block_table(self, seq: int) -> List[int]:
        return list(self._tables[seq])

    def length(self, seq: int) -> int:
        return self._lengths[seq]

    @property
    def sequences(self) -> List[int]:
        return sorted(self._tables)

    # -- snapshot (engine.measure state save/restore) -----------------------

    def snapshot(self) -> dict:
        return {"free": list(self._free),
                "tables": {s: list(t) for s, t in self._tables.items()},
                "lengths": dict(self._lengths)}

    def restore(self, state: dict) -> None:
        self._free = deque(state["free"])
        self._free_set = set(state["free"])
        self._tables = {s: list(t) for s, t in state["tables"].items()}
        self._lengths = dict(state["lengths"])
        self._publish()

    # -- internals ----------------------------------------------------------

    def _take(self) -> int:
        pid = self._free.popleft()
        self._free_set.discard(pid)
        return pid

    def _publish(self) -> None:
        if self._tel is not None:
            m = self._tel.metrics
            m.gauge("page_pool.free_pages").set(float(len(self._free)))
            m.gauge("page_pool.allocated_pages").set(
                float(self.allocated_pages))
            m.gauge("page_pool.occupancy").set(self.occupancy)
            m.gauge("page_pool.internal_fragmentation").set(
                self.internal_fragmentation)
            m.gauge("page_pool.sequences").set(float(len(self._tables)))

    def check_invariants(self) -> None:
        """Assert the pool invariants (used by the property tests)."""
        allocated = [p for t in self._tables.values() for p in t]
        assert len(allocated) == len(set(allocated)), "double allocation"
        assert len(self._free) == len(self._free_set)
        assert not (set(allocated) & self._free_set), "page both states"
        assert len(allocated) + len(self._free) == self.num_pages
        for s, t in self._tables.items():
            assert len(t) == self.pages_for(self._lengths[s])
