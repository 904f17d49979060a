"""Radix index over token ids mapping prompt prefixes to live KV pages.

Copy of ``repro.runtime.prefix_index`` for the port (the reference's
``repro.runtime`` package imports jax on import).

The tree is chunked at page granularity: each node covers exactly one
page worth of token ids (a tuple of ``page_size`` ints) and records the
physical page whose KV rows hold those positions. Matching walks the
tree chunk by chunk, so a hit of depth ``d`` means the first
``d * page_size`` tokens of an incoming prompt are already resident and
the engine can map them with ``PageAllocator.share`` instead of
re-prefilling them.

Every indexed page carries one reference under ``NEUTRAL_OWNER`` — the
tenant-neutral region of the arena. That reference keeps the prefix
warm after the request that populated it finishes; it is *cache*, not
demand, so under page pressure the engine evicts least-recently-matched
leaves (``evict_lru``) before preempting a live request. Only leaves
whose page has refcount 1 (index-only) are evictable: refcount >= 2
means some live request still maps the page, and evicting the node
would merely forget a prefix that is still pinned anyway.

Token ids are compared exactly — position ``i`` of a node's key is KV
position ``i`` of its page — so a match is only valid for requests of
the same model/tenant (the engine keeps one index per tenant; page ids
live in that tenant's partition).
"""

from __future__ import annotations

from .kv_pager import NEUTRAL_OWNER, PageAllocator


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_hit")

    def __init__(self, key: tuple[int, ...], page: int,
                 parent: "_Node | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.last_hit = 0


class PrefixIndex:
    """Page-granular radix tree with LRU leaf eviction.

    The index never allocates pages — it only takes shared references
    on pages the engine already populated (``insert``) and drops them
    (``evict_lru`` / ``release_all``). All refcount bookkeeping goes
    through the allocator, so arena invariants see index pages as
    ordinary live pages under the NEUTRAL_OWNER pseudo-tenant.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._root: dict[tuple[int, ...], _Node] = {}
        self._by_page: dict[int, _Node] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def _chunks(self, tokens: list[int]):
        P = self.page_size
        for i in range(0, (len(tokens) // P) * P, P):
            yield tuple(tokens[i:i + P])

    def match(self, tokens: list[int], *, allow_tail: bool = False
              ) -> tuple[list[int], int]:
        """Longest indexed prefix of ``tokens`` -> (page ids, tokens
        covered). Bumps the LRU clock along the hit path.

        With ``allow_tail``, a prompt whose final partial page is a
        PREFIX of some indexed page's key also matches that page — the
        cached KV at the overlapping positions depends only on the
        (identical) preceding tokens, and the caller's attention length
        gates out the continuation rows beyond the overlap. The caller
        then owns a reference to a page it only partially occupies, so
        its first append into it must copy-on-write."""
        self._clock += 1
        pages: list[int] = []
        children = self._root
        consumed = 0
        for key in self._chunks(tokens):
            node = children.get(key)
            if node is None:
                break
            node.last_hit = self._clock
            pages.append(node.page)
            consumed += self.page_size
            children = node.children
        if (allow_tail and consumed == (len(tokens) // self.page_size)
                * self.page_size and consumed < len(tokens)):
            tail = tuple(tokens[consumed:])
            for key, node in sorted(children.items()):
                if key[:len(tail)] == tail:
                    node.last_hit = self._clock
                    pages.append(node.page)
                    consumed = len(tokens)
                    break
        return pages, consumed

    def insert(self, alloc: PageAllocator, tokens: list[int],
               pages: list[int]) -> int:
        """Index the full-page prefix of ``tokens`` backed by ``pages``
        (the request's page-table row, position-aligned). New nodes take
        a NEUTRAL_OWNER reference on their page; chunks already indexed
        keep the incumbent node's page (dedup — the caller's copy stays
        private). Returns the number of newly indexed pages."""
        self._clock += 1
        added = 0
        children, parent = self._root, None
        for depth, key in enumerate(self._chunks(tokens)):
            if depth >= len(pages):
                break
            node = children.get(key)
            if node is None:
                page = pages[depth]
                if page in self._by_page:
                    # one physical page cannot sit at two tree positions
                    break
                alloc.share(NEUTRAL_OWNER, [page])
                node = _Node(key, page, parent)
                children[key] = node
                self._by_page[page] = node
                added += 1
            node.last_hit = self._clock
            children, parent = node.children, node
        return added

    def evictable(self, alloc: PageAllocator) -> int:
        """Leaves droppable right now (index-only refcount-1 pages)."""
        return sum(1 for n in self._by_page.values()
                   if not n.children and alloc.refcount(n.page) == 1)

    def evict_lru(self, alloc: PageAllocator, need: int = 1,
                  protect: frozenset | set = frozenset()) -> int:
        """Drop up to ``need`` least-recently-matched evictable leaves,
        returning their pages to the free list. Evicting a leaf can
        expose its parent as the next candidate, so the scan repeats
        until satisfied or no leaf qualifies. ``protect`` pins pages an
        in-flight admission plan is about to share (they may still be
        index-only at that point). Returns pages freed."""
        freed = 0
        while freed < need:
            victim = None
            for node in self._by_page.values():
                if (node.children or node.page in protect
                        or alloc.refcount(node.page) != 1):
                    continue
                if victim is None or node.last_hit < victim.last_hit:
                    victim = node
            if victim is None:
                break
            self._drop(alloc, victim)
            freed += 1
        return freed

    def _drop(self, alloc: PageAllocator, node: _Node) -> None:
        assert not node.children, "only leaves are evictable"
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        del siblings[node.key]
        del self._by_page[node.page]
        alloc.free_page(NEUTRAL_OWNER, node.page)

    def release_all(self, alloc: PageAllocator) -> int:
        """Drop every index reference (end of run / tenant teardown).
        Returns the number of references released."""
        n = len(self._by_page)
        if n:
            alloc.free_owner(NEUTRAL_OWNER)
        self._root = {}
        self._by_page = {}
        return n
