"""Paged KV cache bookkeeping: fixed-size pages, free-list allocation.

Copy of ``repro.runtime.kv_pager`` for the port (the reference's
``repro.runtime`` package imports jax on import).

The device side is a shared page pool (models.layers.paged_cache_init)
addressed through int32 page tables; this module is the host side — a
free-list allocator with per-owner tracking so cache bytes follow *live*
tokens instead of ``batch x max_len``. This is the serving transplant of
the paper's packing objective: the dense per-slot cache is the "stacked"
baseline (worst-case rows held whether occupied or not), the page pool is
the packed canvas (only occupied blocks exist), and the free list is the
allocator walking the D_m capacity axis.

Page 0 is reserved as the *trash page*: dead page-table slots point at it
so scatter/gather indices are always valid, and whatever lands there is
never read back (attention lengths gate it out).

Pages are refcounted so one physical page can back the same prompt
prefix across many requests (cross-request prefix sharing): ``alloc``
hands out exclusive pages at refcount 1, ``share`` adds an owner to an
already-live page, and every free is a *drop-ref* — the row returns to
the free list only when its last reference is gone. ``NEUTRAL_OWNER``
is the pseudo-owner the prefix index uses to keep shared prefixes warm
after every sharing request has finished; index-only pages are
reclaimable cache, so ``demand_count`` excludes them.
"""

from __future__ import annotations

import dataclasses

TRASH_PAGE = 0

# Pseudo-owner for pages pinned by the prefix index (tenant-neutral
# region: not any request's demand, evictable on pressure).
NEUTRAL_OWNER = -1


@dataclasses.dataclass(frozen=True)
class PagerConfig:
    """Geometry of the page pool.

    num_pages counts the trash page; usable capacity is num_pages - 1.
    max_pages_per_seq bounds a sequence's page-table row (its max context
    is ``max_pages_per_seq * page_size`` tokens).
    """
    num_pages: int
    page_size: int
    max_pages_per_seq: int

    def __post_init__(self):
        assert self.num_pages >= 2, "need at least one non-trash page"
        assert self.page_size >= 1 and self.max_pages_per_seq >= 1

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache entries."""
        return -(-tokens // self.page_size)

    def steps_to_boundary(self, length: int) -> int:
        """Decode steps a slot at context ``length`` can take before the
        next write needs a page not yet in its table. Called after the
        engine's growth pass, so a page-aligned length means a fresh
        page was just mapped (a full page of headroom); this is the
        per-slot term of the fused-decode horizon, and it covers the
        ring backends too — a ring recycles rows exactly at page
        boundaries, so wrap distance and growth distance coincide."""
        return self.page_size - (length % self.page_size)

    def can_ever_fit(self, prompt_len: int, max_new_tokens: int,
                     context_len: int, num_pages: int) -> bool:
        """Admission feasibility shared by every engine: the cache at
        completion holds prompt + max_new - 1 tokens (the final sampled
        token is never written), and both that and the current context
        must fit the table row and the pool."""
        final_ctx = prompt_len + max_new_tokens - 1
        return (final_ctx <= self.max_context
                and self.pages_for(final_ctx) <= num_pages - 1
                and self.pages_for(context_len) <= num_pages - 1)

    def page_bytes(self, cfg, dtype_bytes: int = 2) -> int:
        """HBM bytes one page holds across all layers, K and V."""
        return (2 * cfg.num_layers * self.page_size * cfg.num_kv_heads
                * cfg.head_dim * dtype_bytes)


class PageAllocator:
    """Free-list page allocator with per-owner accounting and a resizable
    usable-page *limit* (the device-memory arena's lease).

    The physical rows ``{1, .., num_pages-1}`` are fixed at construction;
    ``limit`` caps how many may be live at once. The arena repartitions
    tenants by moving limits, never pages: shrinking only surrenders FREE
    headroom (``set_limit`` refuses to cut below the live count), so a
    live page is never remapped.

    Pages are refcounted: ``alloc`` creates a page at refcount 1,
    ``share`` registers additional owners on live pages, and
    ``free_page`` / ``free_owner`` drop references — a row rejoins the
    free list only at refcount zero. Freeing a page the owner does not
    hold (double-free, or a page another owner still references under a
    stale handle) raises instead of corrupting the free list.

    Invariants (checked by ``check``): the free list and the distinct
    referenced pages partition ``{1, .., num_pages-1}``; each page's
    refcount equals the number of owner lists holding it; no owner holds
    the same page twice; the trash page is never handed out;
    ``live_count <= limit``.
    """

    def __init__(self, num_pages: int, limit: int | None = None):
        self.num_pages = num_pages
        self.limit = (num_pages - 1) if limit is None else limit
        assert 0 <= self.limit <= num_pages - 1
        # LIFO free list: recently freed pages are reused first (warm).
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        self._refs: dict[int, int] = {}

    @property
    def free_count(self) -> int:
        """Pages allocatable right now (free rows within the limit)."""
        return min(len(self._free), self.limit - self.live_count)

    @property
    def live_count(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def shared_count(self) -> int:
        """Live pages referenced by two or more owners."""
        return sum(1 for r in self._refs.values() if r >= 2)

    @property
    def neutral_count(self) -> int:
        """Pages held ONLY by the prefix index (refcount 1 under
        NEUTRAL_OWNER): warm cache, reclaimable on demand."""
        return sum(1 for p in self._owned.get(NEUTRAL_OWNER, ())
                   if self._refs[p] == 1)

    @property
    def demand_count(self) -> int:
        """Live pages some request actually needs (index-only cache
        pages excluded) — the fair basis for peak-KV-byte comparisons
        against a runtime with no prefix index."""
        return self.live_count - self.neutral_count

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def set_limit(self, limit: int) -> None:
        """Resize the usable lease. Growing is bounded by the physical
        rows; shrinking is bounded by the live count — only free pages
        ever leave the lease."""
        assert self.live_count <= limit <= self.num_pages - 1, \
            f"limit {limit} outside [live {self.live_count}, " \
            f"rows {self.num_pages - 1}]"
        self.limit = limit

    def owned(self, owner: int) -> list[int]:
        return list(self._owned.get(owner, ()))

    def can_alloc(self, n: int) -> bool:
        return self.free_count >= n

    def alloc(self, owner: int, n: int) -> list[int] | None:
        """Hand ``n`` pages to ``owner``; None (and no change) if the pool
        can't cover the request — the caller preempts or waits."""
        if n < 0:
            raise ValueError("negative page count")
        if n == 0:
            return []                   # no empty owner-list entries
        if self.free_count < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, owner: int, pages: list[int]) -> None:
        """Add ``owner`` as a reference holder on already-live pages
        (prefix sharing: a new request maps its matched prefix onto
        pages some other owner — or the index — already populated).
        Consumes no free rows, so it never fails on capacity."""
        if len(set(pages)) != len(pages):
            raise ValueError("duplicate pages in share request")
        held = self._owned.get(owner, ())
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"cannot share non-live page {p}")
            if p in held:
                raise ValueError(f"owner {owner} already holds page {p}")
        lst = self._owned.setdefault(owner, [])
        for p in pages:
            self._refs[p] += 1
            lst.append(p)

    def free_page(self, owner: int, page: int) -> None:
        """Drop ``owner``'s reference on ONE page — the window ring's
        recycle path and the CoW unshare path. The row returns to the
        free list only when the last reference is gone. Raises if the
        owner does not hold the page (double-free guard)."""
        pages = self._owned.get(owner)
        if pages is None or page not in pages:
            raise ValueError(
                f"owner {owner} does not hold page {page} (double-free?)")
        pages.remove(page)
        if not pages:
            del self._owned[owner]
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)

    def free_owner(self, owner: int) -> int:
        """Drop all of ``owner``'s references (slot recycle / preemption).
        Rows still referenced by other owners stay live. Returns the
        number of rows actually returned to the free list. Raises on an
        owner with no pages (double-free guard)."""
        pages = self._owned.pop(owner, None)
        if pages is None:
            raise ValueError(
                f"owner {owner} holds no pages (double-free?)")
        released = 0
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                released += 1
        return released

    def check(self) -> None:
        """Assert free-list conservation, per-owner disjointness, and
        refcount agreement with the owner lists."""
        assert self.live_count <= self.limit, \
            f"live {self.live_count} exceeds limit {self.limit}"
        seen: set[int] = set()
        for p in self._free:
            assert 0 < p < self.num_pages, f"free page {p} out of range"
            assert p not in seen, f"page {p} double-listed"
            seen.add(p)
        holders: dict[int, int] = {}
        for owner, pages in self._owned.items():
            assert pages, f"owner {owner} tracked with empty page list"
            assert len(set(pages)) == len(pages), \
                f"owner {owner} holds a page twice"
            for p in pages:
                assert 0 < p < self.num_pages, \
                    f"owner {owner} holds out-of-range page {p}"
                assert p not in seen, f"live page {p} also on free list"
                holders[p] = holders.get(p, 0) + 1
        assert holders.keys() == self._refs.keys(), \
            "refcounted pages != pages held by owners"
        for p, n in holders.items():
            assert self._refs[p] == n, \
                f"page {p} refcount {self._refs[p]} != {n} holders"
        assert seen | holders.keys() == set(range(1, self.num_pages)), \
            "free list + referenced pages do not partition the pool"
