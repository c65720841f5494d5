"""Host-side page allocator for the paged KV cache (port of
``repro/serve/paging.py``, stdlib only).

The device side (``models/kvcache.py``) is dumb on purpose: page pools are
plain buffers and block tables are plain int32 arrays.  All policy lives
here, in ordinary Python on the serve thread:

- a free list over physical page ids 1..P-1 (page 0 is the device-side
  trash/write-sink and is never handed out),
- per-page refcounts so prefix-shared pages stay alive until the last
  slot mapping them retires,
- a content-hash registry (chained blake2b over full token pages) that
  turns "two prompts share a leading prefix" into "their block tables
  point at the same physical pages", and
- LRU retention of *freed* hashed pages: a page whose refcount hits zero
  but whose content is registered parks in an LRU instead of returning
  to the free list, so a later request with the same prefix can revive
  it without recomputing prefill.  Allocation pressure evicts parked
  pages oldest-first.

The allocator never touches device memory; correctness is enforced by
the invariant that a physical page is in exactly one of {free, parked,
live (refcount > 0)} and only live pages appear in live block tables.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def prefix_page_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Chained content hash per *full* leading page of ``tokens``.

    Hash j covers tokens[0 : (j+1)*page_size], so equal hash j implies the
    entire prefix up to and including page j is identical — matching a run
    of leading hashes is exactly matching a shared prompt prefix.  The
    final partial page (if any) is never hashed: its page will also hold
    this request's first generated tokens, so it is never shareable.
    """
    out: List[bytes] = []
    h = hashlib.blake2b(str(page_size).encode(), digest_size=16)
    for j in range(len(tokens) // page_size):
        chunk = tokens[j * page_size:(j + 1) * page_size]
        h.update(b"|".join(str(int(t)).encode() for t in chunk))
        out.append(h.digest())
        h = hashlib.blake2b(out[-1], digest_size=16)
    return out


@dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    prefix_hits: int = 0        # pages reused from a live or parked match
    prefix_queries: int = 0     # full prompt pages that could have matched
    evictions: int = 0
    peak_live: int = 0
    peak_shared_ref: int = 0    # highest refcount any page reached


@dataclass
class PagePool:
    """Refcounted allocator over physical pages 1..num_pages-1."""
    num_pages: int              # INCLUDING the reserved trash page 0
    page_size: int
    refcount: List[int] = field(init=False)
    _free: List[int] = field(init=False)
    # parked: freed-but-hash-registered pages, oldest first (LRU eviction)
    _parked: "OrderedDict[int, bytes]" = field(init=False)
    _page_of_hash: Dict[bytes, int] = field(init=False)
    _hash_of_page: Dict[int, bytes] = field(init=False)
    stats: PoolStats = field(init=False)

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("need at least one allocatable page "
                             "(page 0 is the trash page)")
        self.refcount = [0] * self.num_pages
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._parked = OrderedDict()
        self._page_of_hash = {}
        self._hash_of_page = {}
        self.stats = PoolStats()

    # -- capacity ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._parked)

    @property
    def num_live(self) -> int:
        return sum(1 for r in self.refcount if r > 0)

    def _take_one(self) -> int:
        if self._free:
            return self._free.pop()
        # evict the oldest parked page: drop its hash registration
        page, h = self._parked.popitem(last=False)
        del self._page_of_hash[h]
        del self._hash_of_page[page]
        self.stats.evictions += 1
        return page

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh pages (refcount 1 each), evicting parked
        prefix pages LRU-first under pressure.  Raises when the pool is
        truly out of capacity — the scheduler sizes the pool so a full
        slot complement always fits, so this is a programming error."""
        if n > self.num_free:
            raise RuntimeError(
                f"page pool exhausted: want {n}, free {self.num_free} "
                f"(live {self.num_live}/{self.num_pages - 1})")
        pages = [self._take_one() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        self.stats.allocs += n
        self.stats.peak_live = max(self.stats.peak_live, self.num_live)
        return pages

    # -- refcounting -------------------------------------------------------

    def retain(self, pages: Sequence[int]) -> None:
        """Add a reference to live or parked pages (prefix reuse).  A
        parked page revives: it leaves the LRU but keeps its hash."""
        for p in pages:
            if self.refcount[p] == 0:
                if p not in self._parked:
                    raise RuntimeError(f"retain of free page {p}")
                del self._parked[p]
            self.refcount[p] += 1
            self.stats.peak_shared_ref = max(self.stats.peak_shared_ref,
                                             self.refcount[p])
        self.stats.peak_live = max(self.stats.peak_live, self.num_live)

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; zero-ref pages return to the free
        list, or park in the LRU if their content is hash-registered."""
        for p in pages:
            if self.refcount[p] <= 0:
                raise RuntimeError(f"release of non-live page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                h = self._hash_of_page.get(p)
                if h is None:
                    self._free.append(p)
                else:
                    self._parked[p] = h
                self.stats.frees += 1

    # -- prefix registry ---------------------------------------------------

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest-run match: page ids for the leading run of ``hashes``
        that are registered (live or parked).  Stops at the first miss —
        chained hashes make any later match meaningless."""
        self.stats.prefix_queries += len(hashes)
        out: List[int] = []
        for h in hashes:
            p = self._page_of_hash.get(h)
            if p is None:
                break
            out.append(p)
        self.stats.prefix_hits += len(out)
        return out

    def register(self, page: int, h: bytes) -> None:
        """Publish a live page's content hash so later requests can map
        it.  First writer wins; an existing registration for the same
        hash is kept (both pages hold identical content — re-pointing
        live block tables is not worth it)."""
        if self.refcount[page] <= 0:
            raise RuntimeError(f"register of non-live page {page}")
        if h in self._page_of_hash or page in self._hash_of_page:
            return
        self._page_of_hash[h] = page
        self._hash_of_page[page] = h

    # -- accounting --------------------------------------------------------

    def check_leaks(self) -> None:
        """After every request retired, all pages must be free or parked."""
        live = [p for p in range(1, self.num_pages) if self.refcount[p] > 0]
        if live:
            raise RuntimeError(f"page leak: live refcounts at {live}")

    def report(self) -> Dict[str, float]:
        s = self.stats
        return {
            "num_pages": self.num_pages - 1,
            "page_size": self.page_size,
            "allocs": s.allocs,
            "frees": s.frees,
            "prefix_hits": s.prefix_hits,
            "prefix_queries": s.prefix_queries,
            "prefix_hit_rate": (s.prefix_hits / s.prefix_queries
                                if s.prefix_queries else 0.0),
            "evictions": s.evictions,
            "peak_live": s.peak_live,
            "peak_shared_ref": s.peak_shared_ref,
        }
