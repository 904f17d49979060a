"""Fleet tier: replicated pools behind a demand-driven placement router.

Copy of ``repro.runtime.fleet`` for the port. The replicas share one
params dict, so on the card the weights are held once and only the
tenants' KV pools and decode graphs multiply per replica; the fleet
runs on one card in one process, as the reference's does.

The paper's packing insight — place operands where reload cost is lowest
and keep utilization high — applies unchanged one level up: *models* are
placed across N replicas the same way ``ModelPool`` places layers inside
one HBM budget, by demand-weighted reuse-per-byte. The robustness half
makes the tier production-shaped: a deterministic ``FaultSchedule``
injects replica kills, degraded DMA clocks and stragglers, and the
router re-admits a lost replica's tenants elsewhere with bounded
disruption — no request lost, the re-prefill priced, queue age bounded.

Time is measured in fleet TICKS. One tick drives every live replica one
engine step (a straggling replica accrues fractional speed credit and
only steps when a full step's worth has accumulated), so modeled
durations stay deterministic and hardware-independent like the
engine-step clock underneath.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .engine import PoolEngineConfig, PooledEngine
from .fault_tolerance import Backoff, FaultSchedule, StragglerDetector
from .model_pool import ModelPool, PoolConfig
from .scheduler import Request

KiB = 1 << 10


# --- placement -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelDesc:
    """What placement needs to know about one zoo model — the same
    demand-weighted stationarity value ``ModelPool.pack`` assigns to its
    average weight byte, lifted to whole-model granularity."""
    model_id: str
    cfg: object
    demand: float
    weight_bytes: int
    value_per_byte: float


def zoo_descs(zoo, pcfg: PoolConfig) -> list[ModelDesc]:
    """Probe-pack the whole zoo once to reuse the pool's own value
    function (demand x (1 + MACs/param) averaged over tensors) as the
    placement score. ``zoo``: [(model_id, cfg, demand), ...]."""
    probe = ModelPool(pcfg)
    for mid, cfg, demand in zoo:
        probe.register(mid, cfg, demand)
    plan = probe.pack()
    return [ModelDesc(e.model_id, e.cfg, e.demand, e.weight_bytes,
                      e.value_per_byte)
            for e in plan.entries]


def place_models(descs: list[ModelDesc], n_replicas: int,
                 capacity_bytes: int, *, policy: str = "demand",
                 min_copies: int = 2,
                 fill_frac: float = 0.62) -> list[list[str]]:
    """Assign each model to a subset of replicas. Returns, per replica,
    the sorted list of hosted model ids.

    ``demand`` is the fleet-level analogue of the pool's reuse-per-byte
    packing: pass 1 walks models most-valuable-first (value_per_byte,
    then size) and gives each one ``min(min_copies, n_replicas)`` copies
    on the least-loaded replicas that fit — the availability floor that
    makes single-replica loss survivable. Pass 2 spends leftover
    capacity on extra copies by marginal value ``demand / (copies x
    weight_bytes)`` (another copy of a hot small model beats one of a
    cold giant), stopping at ``fill_frac`` of each replica so admission
    bursts keep slab headroom. Placed bytes only grow, so a model left
    unplaced proves NO replica could ever fit it (the property-test
    invariant).

    ``mirror`` is the static baseline: every model on every replica that
    can hold it — maximum availability, but every replica's pool now
    packs the whole zoo into one budget, so reload thrash is maximal.
    """
    assert policy in ("demand", "mirror")
    assert n_replicas >= 1
    used = [0] * n_replicas
    hosted: list[set[str]] = [set() for _ in range(n_replicas)]

    def fits(r: int, d: ModelDesc) -> bool:
        return used[r] + d.weight_bytes <= capacity_bytes

    if policy == "mirror":
        for d in descs:
            for r in range(n_replicas):
                if fits(r, d):
                    used[r] += d.weight_bytes
                    hosted[r].add(d.model_id)
        return [sorted(h) for h in hosted]

    by_value = sorted(descs, key=lambda d: (-d.value_per_byte,
                                            -d.weight_bytes, d.model_id))
    copies: dict[str, int] = {d.model_id: 0 for d in descs}
    # pass 1: availability floor, least-loaded-bytes replica first
    for d in by_value:
        want = min(min_copies, n_replicas)
        for _ in range(want):
            cands = [r for r in range(n_replicas)
                     if d.model_id not in hosted[r] and fits(r, d)]
            if not cands:
                break
            r = min(cands, key=lambda r: (used[r], r))
            used[r] += d.weight_bytes
            hosted[r].add(d.model_id)
            copies[d.model_id] += 1
    # pass 2: marginal demand per replicated byte, bounded by fill_frac
    cap2 = int(capacity_bytes * fill_frac)
    while True:
        best = None
        for d in descs:
            if copies[d.model_id] == 0:
                continue                # pass 1 proved it can never fit
            gain = d.demand / (copies[d.model_id] * d.weight_bytes)
            cands = [r for r in range(n_replicas)
                     if d.model_id not in hosted[r]
                     and used[r] + d.weight_bytes <= cap2]
            if not cands:
                continue
            r = min(cands, key=lambda r: (used[r], r))
            key = (gain, -d.weight_bytes, d.model_id)
            if best is None or key > best[0]:
                best = (key, d, r)
        if best is None:
            break
        _, d, r = best
        used[r] += d.weight_bytes
        hosted[r].add(d.model_id)
        copies[d.model_id] += 1
    return [sorted(h) for h in hosted]


# --- fleet config / report -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_replicas: int = 2
    placement: str = "demand"          # | "mirror"
    min_copies: int = 2
    fill_frac: float = 0.62
    max_queue_per_replica: int = 32    # admission refusal threshold
    straggler_factor: float = 3.0      # routing-health detection ratio
    backoff: Backoff = dataclasses.field(
        default_factory=lambda: Backoff(base=1, factor=2.0, cap=16))
    max_ticks: int = 200_000


@dataclasses.dataclass
class FleetReport:
    """Fleet-wide outcome + per-replica utilization."""
    placement: dict[str, list[int]]    # model -> hosting replica ids
    n_requests: int = 0
    completed: list[Request] = dataclasses.field(default_factory=list)
    shed: list[Request] = dataclasses.field(default_factory=list)
    new_tokens: int = 0
    fleet_steps: float = 0.0           # decode + stall + prefill-equiv
    reload_bytes: int = 0
    restream_bytes: int = 0
    ticks: int = 0
    failovers: int = 0                 # replica kills that drained work
    re_admissions: int = 0
    re_admission_order: list[int] = dataclasses.field(default_factory=list)
    re_admission_latency: list[int] = dataclasses.field(
        default_factory=list)          # ticks from kill to re-dispatch
    retries: int = 0                   # backoff re-tries after refusals
    queue_ages: list[int] = dataclasses.field(default_factory=list)
    per_replica: list[dict] = dataclasses.field(default_factory=list)

    @property
    def tokens_per_step(self) -> float:
        """Fleet throughput on the pool's own denominator: generated
        tokens per decode-equivalent step of fabric time summed over
        replicas (stalls and re-prefills priced, idle ticks not — an
        idle replica burns no fabric)."""
        return self.new_tokens / max(self.fleet_steps, 1.0)

    @property
    def requests_lost(self) -> int:
        """Accounting invariant: every request completes somewhere or is
        shed (counted, never silent). Anything else is a lost request —
        the chaos tests pin this at zero."""
        return self.n_requests - len(self.completed) - len(self.shed)

    @property
    def requests_shed(self) -> int:
        return len(self.shed)

    def queue_age_percentile(self, q: float) -> float:
        ages = self.queue_ages or [0]
        return float(np.percentile(ages, q))

    def summary(self) -> dict:
        return {
            "n_replicas": len(self.per_replica),
            "requests": self.n_requests,
            "completed": len(self.completed),
            "shed": self.requests_shed,
            "lost": self.requests_lost,
            "new_tokens": self.new_tokens,
            "tokens_per_step": round(self.tokens_per_step, 3),
            "reload_KiB": round(self.reload_bytes / KiB, 1),
            "restream_KiB": round(self.restream_bytes / KiB, 1),
            "ticks": self.ticks,
            "failovers": self.failovers,
            "re_admissions": self.re_admissions,
            "re_admission_latency_max": max(self.re_admission_latency,
                                            default=0),
            "retries": self.retries,
            "queue_age_p50": round(self.queue_age_percentile(50), 1),
            "queue_age_p99": round(self.queue_age_percentile(99), 1),
            "placement": {m: list(rs) for m, rs in
                          sorted(self.placement.items())},
            "per_replica": self.per_replica,
        }


# --- fleet engine --------------------------------------------------------------


@dataclasses.dataclass
class _QueueEntry:
    req: Request
    arrival: int                       # fleet tick it became routable
    next_try: int
    attempts: int = 0
    kill_tick: int | None = None       # set when re-queued by a failover


class _Replica:
    """One PooledEngine plus its fleet-side health bookkeeping."""

    def __init__(self, idx: int, models: list[str], zoo_by_id: dict,
                 pcfg: PoolConfig, ecfg: PoolEngineConfig, params: dict,
                 straggler_factor: float):
        self.idx = idx
        self.name = f"r{idx}"
        self.models = frozenset(models)
        self.pool = ModelPool(pcfg)
        for mid in models:
            cfg, demand = zoo_by_id[mid]
            self.pool.register(mid, cfg, demand)
        self.pool.pack()
        self.engine = PooledEngine(self.pool, {m: params[m]
                                               for m in models}, ecfg)
        self.live = True
        self.detector = StragglerDetector(factor=straggler_factor)
        self.flagged = False
        self.credit = 1.0              # speed credit (straggle divides it)
        self.dma_factor = 1.0
        self._last_advance: int | None = None
        self.ticks_alive = 0
        self.idle_ticks = 0

    def apply_dma(self, factor: float) -> None:
        # chaos and recovery go through the pool's DmaChannel — the same
        # object the supervisor's degraded-link path drives — so the
        # effective clock composes with any re-calibration instead of
        # overwriting it
        if factor != self.dma_factor:
            self.dma_factor = factor
            self.pool.dma.degrade(max(1.0, float(factor)))

    def tick(self, t: int, speed_factor: float) -> bool:
        """Advance up to one engine step, rate-limited by the straggle
        factor: a k-x straggler accrues 1/k credit per tick and only
        steps when a whole step's credit has built up."""
        self.ticks_alive += 1
        self.credit += 1.0 / max(speed_factor, 1.0)
        if self.credit < 1.0:
            return False
        self.credit -= 1.0
        advanced = self.engine.step_once()
        if advanced:
            # health signal derived from observed progress, not from the
            # fault schedule: in the modeled clock a healthy busy replica
            # advances every tick (gap 1), so a rolling-median gap above
            # factor x 1 is a straggler — self-relative detection would
            # never flag a uniformly slow replica
            if self._last_advance is not None:
                self.detector.observe(float(t - self._last_advance))
                med = self.detector.median()
                self.flagged = (med is not None
                                and med > self.detector.factor)
            self._last_advance = t
        else:
            self.idle_ticks += 1
            self._last_advance = None   # idle gaps are not a health signal
        return advanced


class FleetEngine:
    """N replicated pools behind tenant-affinity + least-loaded routing
    with deterministic chaos injection (see module docstring)."""

    def __init__(self, zoo, pcfg: PoolConfig, ecfg: PoolEngineConfig,
                 params: dict, fcfg: FleetConfig | None = None,
                 faults: FaultSchedule | None = None):
        self.fcfg = fcfg or FleetConfig()
        self.faults = faults or FaultSchedule([])
        self.pcfg, self.ecfg = pcfg, ecfg
        descs = zoo_descs(zoo, pcfg)
        placed = place_models(
            descs, self.fcfg.n_replicas, pcfg.hbm_budget_bytes,
            policy=self.fcfg.placement, min_copies=self.fcfg.min_copies,
            fill_frac=self.fcfg.fill_frac)
        zoo_by_id = {mid: (cfg, demand) for mid, cfg, demand in zoo}
        self.replicas = [
            _Replica(i, models, zoo_by_id, pcfg, ecfg, params,
                     self.fcfg.straggler_factor)
            for i, models in enumerate(placed) if models]
        self.placement = {
            d.model_id: [r.idx for r in self.replicas
                         if d.model_id in r.models]
            for d in descs}
        # tenant affinity: the first hosting replica is the primary —
        # keeping a tenant's requests together maximizes weight reuse
        self.primary = {m: rs[0] for m, rs in self.placement.items()
                        if rs}

    # -- routing ------------------------------------------------------------

    def _route(self, req: Request) -> _Replica | str:
        """Pick a live hosting replica: the tenant's primary if healthy
        and unsaturated, else the least-loaded candidate (straggler-
        flagged replicas deprioritized). Returns "shed" when no live
        replica hosts the model, "refused" when all candidates are at
        the queue-depth cap (caller backs off and retries)."""
        cands = [r for r in self.replicas
                 if r.live and req.model_id in r.models]
        if not cands:
            return "shed"
        open_ = [r for r in cands
                 if r.engine.load() < self.fcfg.max_queue_per_replica]
        if not open_:
            return "refused"
        prim = self.primary.get(req.model_id)
        for r in open_:
            if r.idx == prim and not r.flagged:
                return r
        # load counts heads, not how long they have waited: two replicas
        # at equal load can hide one whose head is stuck behind a page-
        # starved tenant, and routing by load alone keeps feeding it.
        # Queued age breaks the tie toward the replica that is draining.
        return min(open_, key=lambda r: (r.flagged, r.engine.load(),
                                         r.engine.oldest_queued_age(),
                                         r.idx))

    # -- chaos --------------------------------------------------------------

    def _apply_faults(self, t: int, rep: FleetReport,
                      queue: list[_QueueEntry]) -> None:
        for r in self.replicas:
            if not r.live:
                continue
            for ev in self.faults.events_at(t, r.name):
                if ev.kind != "kill":
                    continue
                r.live = False
                drained = r.engine.drain()
                # the dead replica's finished work still counts; drain
                # emptied its slots so the leak asserts hold
                rep.per_replica.append(self._replica_row(r, t))
                rep.failovers += 1
                for q in sorted(drained,
                                key=lambda q: (q.arrival, q.rid)):
                    queue.append(_QueueEntry(req=q, arrival=t,
                                             next_try=t, kill_tick=t))
            if r.live:
                r.apply_dma(self.faults.factor("dma", r.name, t))

    def _replica_row(self, r: _Replica, t: int) -> dict:
        e = r.engine.report
        return {
            "replica": r.name,
            "live": r.live,
            "models": sorted(r.models),
            "ticks_alive": r.ticks_alive,
            "idle_ticks": r.idle_ticks,
            "decode_steps": e.decode_steps,
            "stall_steps": e.stall_steps,
            "new_tokens": e.new_tokens,
            "utilization": round(e.useful_slot_steps
                                 / max(e.slot_steps, 1), 3),
            "reload_KiB": round(r.pool.reload_bytes_total / KiB, 1),
            "preemptions": e.preemptions,
            "completed": len(e.completed),
        }

    # -- main loop ----------------------------------------------------------

    def run(self, requests: list[Request]) -> FleetReport:
        fc = self.fcfg
        rep = FleetReport(placement=self.placement,
                          n_requests=len(requests))
        for r in self.replicas:
            r.engine.start([])
        queue = [_QueueEntry(req=q, arrival=q.arrival, next_try=q.arrival)
                 for q in sorted(requests,
                                 key=lambda q: (q.arrival, q.rid))]
        fleet_arrival = {q.rid: q.arrival for q in requests}
        dispatched_at: dict[int, int] = {}
        done = 0
        t = 0
        while done + len(rep.shed) < rep.n_requests:
            self._apply_faults(t, rep, queue)

            # -- dispatch everything routable this tick ---------------
            rest: list[_QueueEntry] = []
            for q in sorted(queue, key=lambda q: (q.arrival,
                                                  q.req.rid)):
                if q.next_try > t:
                    rest.append(q)
                    continue
                verdict = self._route(q.req)
                if verdict == "shed":
                    rep.shed.append(q.req)
                    continue
                if verdict == "refused":
                    q.attempts += 1
                    q.next_try = t + fc.backoff.delay(q.attempts - 1)
                    rep.retries += 1
                    rest.append(q)
                    continue
                replica = verdict
                # the replica's own clock stamps the arrival: it releases
                # on the replica's next scan, never in its future
                q.req.arrival = replica.engine.step
                replica.engine.inject([q.req])
                dispatched_at[q.req.rid] = t
                if q.kill_tick is not None:
                    rep.re_admissions += 1
                    rep.re_admission_order.append(q.req.rid)
                    rep.re_admission_latency.append(t - q.kill_tick)
            queue = rest

            # -- one tick of fleet time -------------------------------
            for r in self.replicas:
                if not r.live:
                    continue
                r.tick(t, self.faults.factor("straggle", r.name, t))
            done = sum(len(r.engine.report.completed)
                       for r in self.replicas)
            t += 1
            if t > fc.max_ticks:
                raise RuntimeError("fleet exceeded max_ticks")

        rep.ticks = t
        for r in self.replicas:
            if r.live:
                r.engine.finish_run()
                rep.per_replica.append(self._replica_row(r, t))
            e = r.engine.report
            rep.completed.extend(e.completed)
            rep.new_tokens += e.new_tokens
            rep.fleet_steps += (e.decode_steps + e.stall_steps
                                + e.prefill_equiv_steps)
            rep.reload_bytes += r.pool.reload_bytes_total
            rep.restream_bytes += r.pool.restream_bytes_total
        for req in rep.completed:
            if req.rid in dispatched_at:
                rep.queue_ages.append(dispatched_at[req.rid]
                                      - fleet_arrival[req.rid])
        assert rep.requests_lost == 0, \
            f"{rep.requests_lost} requests neither completed nor shed"
        return rep
