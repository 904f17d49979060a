"""Unified device-memory arena: one modeled HBM budget for KV pages and
weight slabs, with load-driven repartitioning.

Copy of ``repro.runtime.arena`` for the port (pure Python over the
port's ``PageAllocator``; the reference's ``repro.runtime`` package
imports jax on import).

The paper's thesis is that IMC gains only materialize when array occupancy
is maximized — capacity must follow observed load, not a static split
(LRMP's layer replication is exactly that reallocation). Our serving pool
had the same failure mode one level up: KV pages and weight slabs were
budgeted by two unrelated, statically-sized mechanisms (``num_pages`` in
the engine config, ``slab_bytes`` in the pool config), so headroom in one
could never absorb demand in the other, and the per-tenant page partition
was frozen at init-time demand weights.

``DeviceArena`` owns the whole modeled budget and leases two regions:

  * the **KV page region** — a shared page budget partitioned into
    per-tenant leases, each backed by a ``PageAllocator`` whose *limit*
    (usable lease) is resizable while its physical rows stay fixed;
  * the **weight region** — the pin budget plus the swap slab whose
    occupancy the ``ModelPool`` reports back for the ceiling check.

Load-driven repartitioning: every step the arena samples per-tenant
live-page watermarks and page-starvation events; at epoch boundaries
(``repartition="epoch"``) it shrinks under-watermark tenants' leases and
grows starved ones. Only FREE pages ever move — a shrink can never cut
below the live count, so no live page is remapped — and because tenants'
pages differ in byte size, moves are settled in bytes (a donated dense
page funds fewer latent pages than its count suggests; the remainder
stays in the arena's spare-byte bank). Invariants, asserted by
``check()`` at every epoch:

  conservation   sum(lease_t * page_bytes_t) + spare == initial KV bytes
  disjointness   each tenant's rows partition its own pool (allocator
                 check) and leases never exceed the provisioned caps
  liveness       live_t <= lease_t at all times (free pages move, live
                 pages never do)
  refcounts      every referenced page's refcount equals its holder
                 count and no referenced page sits on the free list
                 (allocator check); shared prefix pages — including the
                 prefix index's tenant-neutral NEUTRAL_OWNER region —
                 count as live, so an epoch shrink can never surrender
                 a page something still references
  demand floor   a tenant's lease never shrinks below its registered
                 ``demand_floor`` (the largest admitted request's
                 remaining page demand), so an epoch shrink cannot
                 preempt-churn a request the engine already admitted
  ceiling        each weight sub-region's reported occupancy stays
                 within its own budget (pinned <= pin_bytes, slab_used
                 <= slab_bytes) — combined with KV conservation, the
                 total modeled footprint can never exceed the budget
                 (a single summed assert would be implied by the other
                 invariants and could never fire)
"""

from __future__ import annotations

import dataclasses
import math

from .kv_pager import PageAllocator


def partition_pages(num_pages: int, shares: dict[str, float]
                    ) -> dict[str, int]:
    """Split a shared page budget into per-tenant sub-ranges.

    ``num_pages`` is the modeled pool budget (counting ONE trash page per
    paged tenant, since each tenant's device pool carries its own);
    ``shares`` maps paged tenant id -> demand weight. Returns usable
    (non-trash) pages per tenant, proportional to demand with the
    remainder going to the largest fractional parts (ties broken by id
    for determinism), every tenant getting at least one page. The
    invariant callers rely on: sum(result[t] + 1) <= num_pages, i.e. the
    physical device pools never exceed the modeled shared budget.
    """
    ids = sorted(shares)
    usable = num_pages - len(ids)      # one trash page per tenant
    assert usable >= len(ids), \
        f"page budget {num_pages} cannot back {len(ids)} paged tenants"
    total = sum(shares[t] for t in ids)
    exact = {t: usable * shares[t] / total for t in ids}
    out = {t: int(exact[t]) for t in ids}
    left = usable - sum(out.values())
    # hand leftover pages to the largest fractional remainders
    for t in sorted(ids, key=lambda t: (-(exact[t] - int(exact[t])), t)):
        if left <= 0:
            break
        out[t] += 1
        left -= 1
    # a starved tenant takes its minimum page from the largest holder
    for t in ids:
        while out[t] < 1:
            donor = max(ids, key=lambda d: (out[d], d))
            assert out[donor] > 1, "unreachable: usable >= len(ids)"
            out[donor] -= 1
            out[t] += 1
    assert sum(v + 1 for v in out.values()) <= num_pages
    return out


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Geometry and policy of the unified device-memory arena.

    ``kv_pages`` is the modeled shared KV budget in pages (one trash page
    per paged tenant included, exactly as ``partition_pages`` counts it).
    ``pin_bytes``/``slab_bytes`` are the weight region's sub-budgets the
    arena co-owns: ``check`` asserts the ModelPool-reported occupancy of
    EACH against its own budget, so a pool accounting bug that overfills
    the slab (or the pin set) trips the arena even though the pool's
    internal arithmetic believed it fit. ``repartition="epoch"`` turns on
    load-driven lease moves every ``epoch_steps``; ``grow_cap`` bounds a
    tenant's physical device-pool provisioning (rows) as a multiple of
    its initial lease, so epoch mode over-provisions device arrays by at
    most that factor while the *modeled* leases stay conserved.
    """
    kv_pages: int
    pin_bytes: int = 0
    slab_bytes: int = 0
    repartition: str = "off"           # | "epoch"
    epoch_steps: int = 64
    min_pages: int = 1
    slack_pages: int = 1               # donors keep watermark + slack
    grow_cap: float = 2.0

    def __post_init__(self):
        assert self.kv_pages >= 2
        assert self.repartition in ("off", "epoch")
        assert self.epoch_steps >= 1
        assert self.min_pages >= 1
        assert self.slack_pages >= 0
        assert self.grow_cap >= 1.0


@dataclasses.dataclass
class _Lease:
    """One paged tenant's slice of the KV region."""
    pages: int                         # current usable lease
    initial: int                       # demand-proportional init lease
    cap: int                           # provisioned physical usable rows
    page_bytes: int = 0
    allocator: PageAllocator | None = None
    # per-epoch load signals
    watermark: int = 0                 # high-water live pages
    starved_steps: int = 0             # steps blocked on pages
    shortfall: int = 0                 # max pages short when blocked
    # shrink floor: the largest admitted request's remaining page
    # demand (engine-maintained) — an epoch shrink below this would
    # force that request into preempt-churn it can never escape
    demand_floor: int = 0


class DeviceArena:
    """One allocator for KV pages and weight slabs over a shared budget."""

    def __init__(self, acfg: ArenaConfig, shares: dict[str, float]):
        self.acfg = acfg
        split = partition_pages(acfg.kv_pages, shares) if shares else {}
        self._leases: dict[str, _Lease] = {}
        for t, n in split.items():
            cap = n if acfg.repartition == "off" \
                else max(n, math.ceil(n * acfg.grow_cap))
            self._leases[t] = _Lease(
                pages=n, initial=n, cap=cap,
                allocator=PageAllocator(cap + 1, limit=n))
        self._spare_bytes = 0          # byte remainder from lease moves
        self._kv_bytes0: int | None = None   # set once page_bytes known
        self._last_epoch = 0
        self.repartitions = 0
        self.pages_moved = 0
        self.clamped_grows = 0
        self.history: list[dict] = []  # per-epoch watermark/move trace
        self._starved_at: dict[str, int] = {}   # dedup starve per step

    # -- construction-time wiring -------------------------------------------

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(sorted(self._leases))

    @property
    def page_split(self) -> dict[str, int]:
        """Initial demand-proportional leases (the static partition)."""
        return {t: l.initial for t, l in self._leases.items()}

    def lease(self, tenant: str) -> int:
        return self._leases[tenant].pages

    def cap(self, tenant: str) -> int:
        """Provisioned physical usable rows (device pool = cap + 1)."""
        return self._leases[tenant].cap

    def allocator(self, tenant: str) -> PageAllocator:
        return self._leases[tenant].allocator

    def register_page_bytes(self, tenant: str, nbytes: int) -> None:
        """Bind a tenant's per-page HBM bytes (known once its backend is
        built); the conservation baseline freezes when every tenant has
        registered."""
        assert nbytes > 0
        self._leases[tenant].page_bytes = nbytes
        if all(l.page_bytes for l in self._leases.values()):
            self._kv_bytes0 = self.kv_leased_bytes + self._spare_bytes

    @property
    def kv_leased_bytes(self) -> int:
        return sum(l.pages * l.page_bytes for l in self._leases.values())

    @property
    def total_budget_bytes(self) -> int:
        """Whole modeled arena: weight region + the KV region baseline."""
        return (self.acfg.pin_bytes + self.acfg.slab_bytes
                + (self._kv_bytes0 or 0))

    # -- runtime ------------------------------------------------------------

    def reset_runtime(self) -> None:
        """Back to the initial partition with fresh allocators (a fresh
        serving run must not inherit the previous run's lease drift)."""
        for lease in self._leases.values():
            lease.pages = lease.initial
            lease.allocator = PageAllocator(lease.cap + 1,
                                            limit=lease.initial)
            lease.watermark = 0
            lease.starved_steps = 0
            lease.shortfall = 0
            lease.demand_floor = 0
        self._spare_bytes = 0
        if self._kv_bytes0 is not None:
            self._kv_bytes0 = self.kv_leased_bytes
        self._last_epoch = 0
        self.repartitions = 0
        self.pages_moved = 0
        self.clamped_grows = 0
        self.history = []
        self._starved_at = {}

    def set_demand_floor(self, tenant: str, pages: int) -> None:
        """Register the largest admitted request's remaining page demand
        (the engine recomputes this every step over its occupied slots).
        ``maybe_repartition`` never shrinks the lease below it — without
        the floor, an epoch shrink to ``watermark + slack`` could leave
        an already-admitted request unable to ever grow to its final
        context, preempt-churning it until the next grow epoch."""
        self._leases[tenant].demand_floor = pages

    def note_starved(self, tenant: str, step: int, want: int = 1) -> None:
        """Record that ``tenant`` was blocked on pages this step (counted
        once per step no matter how many scans hit the wall). ``want`` is
        the page count that would have unblocked it — the repartition
        grow quantum."""
        lease = self._leases[tenant]
        free = lease.pages - lease.allocator.live_count
        lease.shortfall = max(lease.shortfall, want - free)
        if self._starved_at.get(tenant) == step:
            return
        self._starved_at[tenant] = step
        lease.starved_steps += 1

    def sample(self) -> None:
        """Per-step watermark update (high-water live pages this epoch)."""
        for lease in self._leases.values():
            lease.watermark = max(lease.watermark,
                                  lease.allocator.live_count)

    def next_epoch_step(self) -> int | None:
        """Step at which ``maybe_repartition`` would next fire, or None
        when repartitioning is off. The fused-decode engine clamps its
        horizon so the epoch boundary lands on an engine step exactly as
        it does under per-step dispatch."""
        if self.acfg.repartition != "epoch":
            return None
        return self._last_epoch + self.acfg.epoch_steps

    def maybe_repartition(self, step: int) -> list[dict] | None:
        """At an epoch boundary, move free pages from under-watermark
        tenants to page-starved ones. Returns the move records (possibly
        empty) at a boundary, None otherwise. Moves settle in bytes: a
        donor's surrendered pages fund ``bytes // page_bytes_receiver``
        receiver pages, the remainder banking as spare for later epochs.
        """
        a = self.acfg
        # elapsed-steps trigger (not modulo): the engine fast-forwards
        # over idle gaps, so step values can skip any fixed boundary
        if a.repartition != "epoch" \
                or step - self._last_epoch < a.epoch_steps:
            return None
        self._last_epoch = step
        moves: list[dict] = []
        leases = self._leases
        # donors: free pages above (watermark + slack), never below the
        # floor, never a live page, and never below the largest admitted
        # request's remaining demand (the watermark only records pages
        # touched SO FAR — an admitted long request's future growth is
        # invisible to it, and shrinking into that demand preempt-churns
        # a request admission already committed to)
        surplus = {
            t: max(0, lease.pages - max(lease.watermark + a.slack_pages,
                                        lease.allocator.live_count,
                                        lease.demand_floor,
                                        a.min_pages))
            for t, lease in leases.items()}
        starved = sorted(
            (t for t, lease in leases.items()
             if lease.starved_steps > 0 and lease.pages < lease.cap),
            key=lambda t: (-leases[t].starved_steps, t))
        for r in starved:
            lr = leases[r]
            want = min(max(lr.shortfall, 1) + a.slack_pages,
                       lr.cap - lr.pages)
            if want <= 0:
                self.clamped_grows += 1
                continue
            bank = self._spare_bytes
            taken: list[tuple[str, int]] = []
            for d in sorted(surplus,
                            key=lambda t: (-surplus[t] *
                                           leases[t].page_bytes, t)):
                if d == r or surplus[d] <= 0:
                    continue
                if bank >= want * lr.page_bytes:
                    break
                need_bytes = want * lr.page_bytes - bank
                n = min(surplus[d],
                        -(-need_bytes // leases[d].page_bytes))
                bank += n * leases[d].page_bytes
                surplus[d] -= n
                taken.append((d, n))
            gained = min(want, bank // lr.page_bytes) \
                if lr.page_bytes else 0
            if gained <= 0:
                # nothing to fund the grow: return the bank untouched
                for d, n in taken:
                    surplus[d] += n
                continue
            # commit: shrink donors (free pages only), grow the receiver
            for d, n in taken:
                ld = leases[d]
                ld.pages -= n
                ld.allocator.set_limit(ld.pages)
                self.pages_moved += n
            lr.pages += gained
            lr.allocator.set_limit(lr.pages)
            self._spare_bytes = bank - gained * lr.page_bytes
            moves.append({"to": r, "pages": gained,
                          "from": [{"tenant": d, "pages": n}
                                   for d, n in taken if n]})
        self.repartitions += 1
        self.history.append({
            "step": step,
            "watermarks": {t: leases[t].watermark for t in self.tenants},
            "starved_steps": {t: leases[t].starved_steps
                              for t in self.tenants},
            "leases": {t: leases[t].pages for t in self.tenants},
            "demand_floors": {t: leases[t].demand_floor
                              for t in self.tenants},
            "shared_pages": {t: leases[t].allocator.shared_count
                             for t in self.tenants},
            "neutral_pages": {t: leases[t].allocator.neutral_count
                              for t in self.tenants},
            "spare_bytes": self._spare_bytes,
            "moves": moves,
        })
        for lease in leases.values():          # fresh epoch signals
            lease.watermark = lease.allocator.live_count
            lease.starved_steps = 0
            lease.shortfall = 0
        self.check()
        return moves

    # -- invariants ---------------------------------------------------------

    def check(self, slab_used: int | None = None,
              pinned_bytes: int | None = None) -> None:
        """Assert the arena invariants (see module docstring). The weight
        region's occupancy is the ModelPool's to report; each sub-region
        is checked against its OWN configured budget (asserting only the
        sum would be implied by KV conservation and thus unfalsifiable),
        so the total modeled footprint can never exceed the budget."""
        for t, lease in self._leases.items():
            a = lease.allocator
            a.check()                          # rows + refcounts conserve
            assert a.live_count <= lease.pages, \
                f"{t}: live {a.live_count} exceeds lease {lease.pages}"
            assert self.acfg.min_pages <= lease.pages <= lease.cap, \
                f"{t}: lease {lease.pages} outside [min, cap]"
            assert 0 <= a.demand_count <= a.live_count, \
                f"{t}: demand {a.demand_count} outside [0, live]"
        if self._kv_bytes0 is not None:
            got = self.kv_leased_bytes + self._spare_bytes
            assert got == self._kv_bytes0, \
                f"KV bytes not conserved: {got} != {self._kv_bytes0}"
        if slab_used is not None:
            assert slab_used <= self.acfg.slab_bytes, \
                f"slab overfilled: {slab_used} > {self.acfg.slab_bytes}"
        if pinned_bytes is not None:
            assert pinned_bytes <= self.acfg.pin_bytes, \
                f"pin set overfilled: {pinned_bytes} > " \
                f"{self.acfg.pin_bytes}"

    def summary(self) -> dict:
        return {
            "kv_pages": self.acfg.kv_pages,
            "repartition": self.acfg.repartition,
            "repartitions": self.repartitions,
            "pages_moved": self.pages_moved,
            "clamped_grows": self.clamped_grows,
            "spare_bytes": self._spare_bytes,
            "leases": {t: {
                "pages": lease.pages, "initial": lease.initial,
                "cap": lease.cap, "page_bytes": lease.page_bytes,
                "watermark": lease.watermark,
                "live": lease.allocator.live_count,
                "demand_floor": lease.demand_floor,
                "shared": lease.allocator.shared_count,
                "neutral": lease.allocator.neutral_count,
            } for t, lease in self._leases.items()},
        }
