"""Host-side page allocator for the paged KV cache.

A copy of `repro.launch.paging` (the port imports nothing of the JAX
package); given the same sequence of calls it makes the same decisions.

The device side is dumb on purpose: a global page pool
`(num_pages, page_size, KVH, hd)` per layer plus one `(B, max_pages)` int32
page table, read by the attention kernel (one table lookup per key row)
and written through by the decode scatter.  ALL policy lives here, on the
host, in plain Python:

  - a free list + per-page refcounts: freed slots return their pages, so
    pool occupancy tracks LIVE tokens instead of worst-case capacity;
  - prefix sharing: admitted token ids are hashed page by page into a chain
    (h_j = hash(h_{j-1}, tokens of page j)), and a new request whose prompt
    matches a registered chain reuses those physical pages with a refcount
    bump: a system prompt shared by N slots is stored ONCE.  The hash of a
    tuple of ints does not depend on PYTHONHASHSEED;
  - copy-on-write: a write into a page with refcount > 1 first copies it to
    a fresh page (the caller does the device copy; `cow()` does the
    bookkeeping), so sharers never observe each other's tokens.

Page 0 is reserved as the TRASH page: dead page-table entries point at it,
so the masked decode writes of inactive slots and the unused table entries
of short slots always index in-bounds without any device-side branching.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Sequence, Tuple

#: reserved physical page every dead/unmapped table entry points at
TRASH_PAGE = 0

_CHAIN_SEED = 0x9E3779B9


def _chain(h: int, chunk: Tuple[int, ...], partial: bool) -> Tuple:
    """Key of the page holding `chunk` when the pages BEFORE it hash to `h`.
    Partial (tail) pages key on their exact token count too, so a 5-token
    tail never matches an 8-token page that happens to share a prefix."""
    return ("part" if partial else "full", h, chunk)


class PoolExhausted(RuntimeError):
    """The page pool has no free pages left for an allocation."""


class PageError(RuntimeError):
    """A page lifecycle violation: double free, freeing a shared page,
    retaining a dead page, or a conservation (leak) failure.  These are
    always caller bugs — the allocator refuses to limp along with corrupt
    refcounts, because a wrong refcount silently aliases two slots' KV."""


class PageAllocator:
    """Free list + refcounts + prefix registry over `num_pages` pages of
    `page_size` tokens (page 0 reserved as trash)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + trash")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = deque(range(1, num_pages))
        self._ref = {}          # page -> refcount (absent == free)
        self._registry = {}     # chain key -> page
        self._page_key = {}     # page -> chain key (for cleanup)
        self.cow_copies = 0     # total copy-on-write page copies

    # -- allocation ---------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take `n` fresh pages (refcount 1)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def can_admit(self, tokens: int, reclaimable: int = 0) -> bool:
        """Watermark admission control: would a request writing `tokens`
        cache entries fit in the free pages plus `reclaimable` pages the
        scheduler could preempt back (non-shared pages of victim slots — the
        caller computes that sum, because only it knows which slots are
        preemptible)?  `tokens` counts every cache index the request will
        touch through its first decode write (prompt + 1).  The credit is
        capped at the pool's allocatable size: no amount of reclaim makes a
        request fit that a fully-free pool cannot hold."""
        need = -(-max(0, int(tokens)) // self.page_size)
        avail = len(self._free) + max(0, int(reclaimable))
        return need <= min(avail, self.num_pages - 1)

    def retain(self, pages: Iterable[int]) -> None:
        """Add one reference to each (already-live) page.  Retaining a freed
        page (or trash) is a hard error: it would resurrect recycled KV."""
        pages = list(pages)
        for p in pages:
            if p not in self._ref:
                raise PageError(f"retain of dead page {p} (refcount 0)")
        for p in pages:
            self._ref[p] += 1

    def release(self, pages: Iterable[int]) -> List[int]:
        """Drop one reference per page; pages reaching zero return to the
        free list (and leave the prefix registry).  Returns the freed ones.
        Releasing an already-free page is a hard error (double free)."""
        freed = []
        for p in pages:
            if p not in self._ref:
                raise PageError(f"double free of page {p} (refcount already 0)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self.invalidate(p)
                self._free.append(p)
                freed.append(p)
        return freed

    def free(self, pages: Iterable[int]) -> None:
        """Hard-deallocate exclusively-owned pages.  Unlike `release` (a
        refcount decrement that tolerates sharing), `free` demands refcount
        exactly 1: freeing a shared page out from under its other referents,
        or a page that is already free, is a hard error."""
        pages = list(pages)
        for p in pages:
            r = self._ref.get(p, 0)
            if r == 0:
                raise PageError(f"double free of page {p} (refcount already 0)")
            if r > 1:
                raise PageError(
                    f"free of shared page {p} (refcount {r}); release() drops "
                    "one reference, free() requires exclusive ownership")
        for p in pages:
            del self._ref[p]
            self.invalidate(p)
            self._free.append(p)

    def leak_check(self) -> None:
        """Conservation invariant: every page is exactly one of free, live
        (refcount >= 1), or the reserved trash page.  Raises PageError on any
        leak, double-accounting, or trash-page corruption.  Called at
        end-of-serve."""
        free = list(self._free)
        free_set = set(free)
        if len(free_set) != len(free):
            raise PageError("free list contains duplicates")
        if TRASH_PAGE in free_set or TRASH_PAGE in self._ref:
            raise PageError("trash page 0 entered the free list or went live")
        overlap = free_set & set(self._ref)
        if overlap:
            raise PageError(f"pages both free and live: {sorted(overlap)}")
        bad_ref = [p for p, r in self._ref.items() if r < 1]
        if bad_ref:
            raise PageError(f"live pages with refcount < 1: {sorted(bad_ref)}")
        total = len(free_set) + len(self._ref) + 1  # +1: trash
        if total != self.num_pages:
            raise PageError(
                f"page leak: {len(free_set)} free + {len(self._ref)} live "
                f"+ 1 trash = {total}, pool has {self.num_pages}")
        dangling = [p for p in self._page_key if p not in self._ref]
        if dangling:
            raise PageError(f"freed pages still registered: {sorted(dangling)}")

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def shared(self, page: int) -> bool:
        return self._ref.get(page, 0) > 1

    # -- prefix sharing -----------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest registered prefix of `tokens`, page by page.

        Returns (pages, covered_tokens).  Full pages chain first; a trailing
        partial page matches only if some slot registered exactly that tail
        (same tokens, same count) — the caller must treat a matched PARTIAL
        page as write-hazardous (it will CoW before appending into it).
        The caller still owns the refcount bump (``retain``)."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        pages: List[int] = []
        covered = 0
        h = _CHAIN_SEED
        while covered + ps <= len(toks):
            chunk = toks[covered:covered + ps]
            page = self._registry.get(_chain(h, chunk, partial=False))
            if page is None:
                return pages, covered
            pages.append(page)
            covered += ps
            h = hash((h, chunk))
        rest = toks[covered:]
        if rest:
            page = self._registry.get(_chain(h, rest, partial=True))
            if page is not None:
                pages.append(page)
                covered += len(rest)
        return pages, covered

    def register_prefix(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Publish `tokens` (living in `pages`, page_size per page, ragged
        tail allowed) so later admissions can share them.  Pages already
        registered under the same chain key (a matched shared prefix) are
        left alone; a first-writer-wins rule keeps the registry consistent
        when two identical prompts are admitted back to back."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        h = _CHAIN_SEED
        for i, page in enumerate(pages):
            chunk = toks[i * ps:(i + 1) * ps]
            if not chunk:
                break
            key = _chain(h, chunk, partial=len(chunk) < ps)
            if key not in self._registry:
                self._registry[key] = page
                self._page_key[page] = key
            if len(chunk) < ps:
                break
            h = hash((h, chunk))

    def invalidate(self, page: int) -> None:
        """Unpublish `page` from the prefix registry (its content is about to
        change, or it was freed).  No-op for unregistered pages."""
        key = self._page_key.pop(page, None)
        if key is not None and self._registry.get(key) == page:
            del self._registry[key]

    def cow(self, page: int) -> int:
        """Copy-on-write bookkeeping for a write into a SHARED page: drop our
        reference on `page`, take a fresh page (refcount 1), count the copy.
        The caller performs the device-side content copy old -> new."""
        assert self.shared(page), f"page {page} not shared (ref {self.refcount(page)})"
        new = self.alloc(1)[0]
        self._ref[page] -= 1
        self.cow_copies += 1
        return new

    # -- occupancy stats ----------------------------------------------------

    def pages_live(self) -> int:
        """Distinct physical pages holding data (trash excluded)."""
        return len(self._ref)

    def pages_shared(self) -> int:
        """Physical pages referenced by more than one slot."""
        return sum(1 for r in self._ref.values() if r > 1)

    def pages_logical(self) -> int:
        """Page-table entries backed by live pages, counted PER SLOT — what a
        dense per-slot cache would have to store."""
        return sum(self._ref.values())

    def capacity_multiplier(self) -> float:
        """Logical / physical pages: >1 exactly when prefixes are shared —
        the effective-capacity win of paging + dedupe."""
        return self.pages_logical() / max(1, self.pages_live())

    def free_pages(self) -> int:
        return len(self._free)
