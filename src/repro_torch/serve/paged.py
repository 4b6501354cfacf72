"""Paged KV-cache block allocator: free-list pages, per-sequence tables
(port of ``repro.serve.paged``; host-only numpy, no torch).

Host-side bookkeeping for the paged pool in ``kernels/paged_kv.py`` —
the vLLM-style split where the device holds a flat page pool and this
module decides which physical page each sequence's logical page maps to.

* ``PageAllocator`` — fixed population of ``num_pages`` pages of
  ``page_size`` token rows.  Page 0 is reserved as the *trash page*:
  idle slots and unallocated page-table entries point at it, so device
  code never needs a "no page" sentinel (reads there are masked by
  ``seq_lens``; writes are garbage by construction).
* Pages are refcounted so ``fork`` can share a prefix between sequences
  (the allocator half of prefix caching).  ``free`` decrements and only
  returns a page to the free list when its last owner drops it.
* ``SlotPages`` — one sequence's page list + grow/seq-len logic; the
  engine keeps one per slot and mirrors it into the device page table.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional

import numpy as np

from ..obs.tracer import _NULL_SPAN

TRASH_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` rows."""
    return -(-max(tokens, 0) // page_size)


class PageAllocator:
    """Free-list allocator over a fixed page population (page 0 reserved).

    ``metrics``/``tracer`` (:mod:`repro_torch.obs`) are optional: when
    given, alloc/free/fork maintain ``pages.*`` counters plus the
    ``pages.live`` gauge, and each mutation gets a span (cat ``alloc``)
    while tracing is enabled."""

    def __init__(self, num_pages: int, page_size: int, *,
                 metrics=None, tracer=None, faults=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self.metrics = metrics
        self.tracer = tracer
        # optional FaultInjector (serve/faults.py): pool_dry faults force
        # alloc to report a dry pool, fork_fail faults raise from fork
        # before anything is mutated
        self.faults = faults
        # LIFO free list keeps recently-freed (cache-warm) pages hot
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._refs = np.zeros(num_pages, np.int32)
        self._refs[TRASH_PAGE] = 1          # never allocatable

    _COUNTERS = {"alloc": "pages.allocated", "free": "pages.freed",
                 "fork": "pages.forked"}

    def _count(self, op: str, n: int) -> None:
        m = self.metrics
        if m is None:
            return
        m.counter(f"pages.{op}_calls").inc()
        m.counter(self._COUNTERS[op]).inc(n)
        m.gauge("pages.live").set(self.live_pages)

    def _span(self, op: str):
        tr = self.tracer
        if tr is None:
            return _NULL_SPAN
        return tr.span(f"pages.{op}", cat="alloc")

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Allocated pages (excludes the trash page)."""
        return self.num_pages - 1 - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (refcount 1 each); None if insufficient —
        all-or-nothing, so a partially admissible request never strands
        pages."""
        with self._span("alloc"):
            if n > len(self._free) or (
                    self.faults is not None and self.faults.on_alloc(n)):
                if self.metrics is not None:
                    self.metrics.counter("pages.alloc_failures").inc()
                return None
            pages = [self._free.pop() for _ in range(n)]
            self._refs[pages] = 1
            self._count("alloc", n)
            return pages

    def _check_pages(self, pages: List[int], op: str) -> None:
        """Validate a page list BEFORE mutating any state, so an invalid
        call raises a clear error and leaves the free list untouched.
        Catches: out-of-range ids (negative ids would silently wrap under
        numpy indexing), the reserved trash page 0, and pages whose
        refcount cannot cover the requested drops (double free /
        fork-after-free), including duplicates within one call."""
        for p, n in Counter(pages).items():
            if not 0 <= p < self.num_pages:
                raise ValueError(f"{op} of out-of-range page {p} "
                                 f"(pool holds {self.num_pages})")
            if p == TRASH_PAGE:
                raise ValueError(f"{op} of reserved trash page 0")
            if self._refs[p] <= 0:
                raise ValueError(
                    f"{op} of page {p} that is not allocated "
                    f"({'double free' if op == 'free' else 'freed page'})")
            if op == "free" and self._refs[p] < n:
                raise ValueError(f"double free of page {p} "
                                 f"({n} drops, refcount {self._refs[p]})")

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; pages return to the free list at
        refcount 0.  All-or-nothing: an invalid list (double free, trash
        page, out of range) raises before any refcount moves."""
        with self._span("free"):
            self._check_pages(pages, "free")
            for p in pages:
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
            self._count("free", len(pages))

    def fork(self, pages: List[int]) -> List[int]:
        """Share ``pages`` with a new owner (prefix sharing): bump each
        refcount and return the same physical page list.  The caller must
        copy-on-write before mutating a page whose refcount is > 1.
        All-or-nothing: forking a freed / trash / out-of-range page raises
        before any refcount moves."""
        with self._span("fork"):
            if self.faults is not None:
                self.faults.on_fork()
            self._check_pages(pages, "fork")
            for p in pages:
                self._refs[p] += 1
            self._count("fork", len(pages))
            return list(pages)

    def ref_count(self, page: int) -> int:
        return int(self._refs[page])

    def assert_consistent(self) -> None:
        """Allocator invariant check, O(num_pages): the free list and the
        refcounted (live) set partition the non-trash pages exactly —
        every page is free with refcount 0 or allocated with refcount
        >= 1, the free list holds no duplicates, and the trash page is
        permanently referenced and never free.  Raises AssertionError
        with the offending pages."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            dup = [p for p, n in Counter(self._free).items() if n > 1]
            raise AssertionError(f"free list holds duplicates: {dup}")
        if TRASH_PAGE in free_set:
            raise AssertionError("trash page 0 is on the free list")
        if self._refs[TRASH_PAGE] != 1:
            raise AssertionError(
                f"trash page refcount {int(self._refs[TRASH_PAGE])} != 1")
        if (self._refs < 0).any():
            bad = np.nonzero(self._refs < 0)[0].tolist()
            raise AssertionError(f"negative refcounts on pages {bad}")
        bad = [p for p in range(1, self.num_pages)
               if (p in free_set) == (self._refs[p] > 0)]
        if bad:
            detail = {p: (int(self._refs[p]), p in free_set) for p in bad}
            raise AssertionError(
                "refcount/free-list mismatch (page: (refs, on_free)): "
                f"{detail}")


@dataclasses.dataclass
class SlotPages:
    """One sequence's page list (logical order) + growth bookkeeping.
    Sequence length itself stays the engine's (``slot_pos``) — one source
    of truth; callers pass the target length to ``pages_needed``."""

    page_size: int
    pages: List[int] = dataclasses.field(default_factory=list)

    def pages_needed(self, new_len: int) -> int:
        """Extra pages required to grow to ``new_len`` tokens."""
        return max(pages_for(new_len, self.page_size) - len(self.pages), 0)

    def table_row(self, pmax: int) -> np.ndarray:
        """(pmax,) i32 device page-table row (trash-padded)."""
        row = np.full(pmax, TRASH_PAGE, np.int32)
        row[: len(self.pages)] = self.pages
        return row
