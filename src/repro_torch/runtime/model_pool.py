"""Multi-tenant weight residency: pack a model zoo into one HBM pool.

Port of ``repro.runtime.model_pool``, copied but for the reload clock:
``calibrated_reload_bytes_per_step`` prices a step and the reload link
on one H100 (its HBM rate and its host link) instead of reading the
reference's TPU roofline artifacts, and ``PoolConfig.dma_device``
names the card a ``DeviceDmaChannel`` copies to.

The paper's packing algorithm decides, offline, which weight tiles live in
the IMC macros and which stream from DRAM. Serving several model families
from one accelerator pool poses the same problem one level up — the HBM
byte budget is the macro capacity, whole models are the layers, and the
reload of a swapped-out model's weights is the DRAM weight-loading term of
cost_model.py (energy per byte, latency serial with compute, §2.2).

``ModelPool`` bin-packs the weight inventories (planner.residency) of N
registered model configs into a shared budget:

  * resident — every tensor pinned in HBM; activation is free;
  * streamed — the high-value tensors pinned, the remainder fetched into
    the swap slab on each activation (the §3.4 spill transplant: tensors
    with the least compute reuse per byte lose the least from streaming);
  * evicted  — nothing pinned; the full weight set reloads per activation.

A fraction of the budget (``slab_frac``) is reserved as the *swap slab*
that holds the working sets of whichever streamed/evicted models are
currently hot. When the slab is full, eviction is least-value-per-byte
first (the paper's fold-lowest-latency-first heuristic, demand-weighted),
with hysteresis: a model activated fewer than ``hysteresis_steps`` engine
steps ago is never evicted, so thrashing traces wait instead of
ping-ponging weights.
"""

from __future__ import annotations

import dataclasses
import statistics

from ..planner.residency import (QUANT_MODES, double_buffer_bytes,
                                 layer_schedule, quant_bytes,
                                 weight_inventory)
from .dma import DeviceDmaChannel, DmaChannel

KiB = 1 << 10

#: the reload path of one NVIDIA H100 SXM, host DRAM -> HBM, in bytes/s:
#: its PCIe Gen5 x16 host link, 32 GT/s a lane x 16 lanes with 128b/130b
#: coding = 63.0 GB/s a direction (PCI-SIG PCIe 5.0 base specification;
#: NVIDIA's H100 SXM data sheet lists PCIe Gen5 128 GB/s, both directions).
#: Deliberately the off-chip clock, not HBM bandwidth: reloading a swapped
#: model crosses the slow interface, which is the §2.2 DRAM weight-loading
#: term the paper pipelines away. ``DeviceDmaChannel`` measures the real
#: pinned host-to-device rate beside it.
HOST_LINK_BYTES_PER_S = 32e9 * 16 * 128 / 130 / 8

#: HBM3 bandwidth of one H100 SXM (NVIDIA data sheet): a decode step
#: reads every weight once, so its bound is weight bytes over this rate.
HBM_BYTES_PER_S = 3.35e12


def model_weight_bytes(cfg, param_bytes: int = 2) -> int:
    """Serving-copy weight footprint of one model (the quantity the pool
    bin-packs; also what callers should use to size budgets)."""
    return param_bytes * sum(t.params for t in weight_inventory(cfg))


def decode_step_bound_s(cfg, *, hbm_bw: float = HBM_BYTES_PER_S,
                        param_bytes: int = 2) -> float:
    """One H100's bound for a full-size decode step of ``cfg``: its weight
    bytes read once at the HBM rate."""
    return model_weight_bytes(cfg, param_bytes) / hbm_bw


def calibrated_reload_bytes_per_step(zoo, *,
                                     link_bw: float = HOST_LINK_BYTES_PER_S,
                                     hbm_bw: float = HBM_BYTES_PER_S,
                                     param_bytes: int = 2) -> int:
    """One clock for kernel-level and pool-level results.

    An engine step *is* a decode step, whose duration is one H100's bound
    for the full-size arch's decode step (``decode_step_bound_s``). On
    that clock the full-size model reloads over the host link in
    ``full_weight_bytes / (link_bw * step_s)`` engine steps; the serving
    copy in ``zoo`` (usually a ``.reduced()`` config) is given the *same
    steps-to-reload*, i.e. its bytes-per-step is ``serving_weight_bytes /
    steps_full``. The median across the zoo is returned so one DMA clock
    serves the whole pool. (With both rates fixed, every arch reloads in
    ``hbm_bw / link_bw`` steps, about 53.)

    ``zoo`` is an iterable of ``(arch_id, serving_cfg)`` pairs.
    """
    from ..configs import get_config

    per_arch = []
    for arch_id, serving_cfg in zoo:
        full = get_config(arch_id)
        step_s = decode_step_bound_s(full, hbm_bw=hbm_bw,
                                     param_bytes=param_bytes)
        steps_full = model_weight_bytes(full, param_bytes) / (
            link_bw * step_s)
        per_arch.append(
            model_weight_bytes(serving_cfg, param_bytes) / steps_full)
    if not per_arch:
        raise ValueError("calibrated_reload_bytes_per_step: empty zoo")
    return max(1, int(statistics.median(per_arch)))


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Byte budget and reload economics of the shared pool.

    ``reload_bytes_per_step`` is the DRAM->HBM bandwidth expressed in
    engine steps — reloads are serial with compute (§2.2), so activating a
    cold model stalls the engine ``ceil(reload_bytes / bandwidth)`` steps.

    ``slab_mode`` sets what a streamed/evicted model RESERVES in the swap
    slab while hot: ``full`` holds its whole reload working set resident
    (the first design), refusing any model whose set exceeds the slab;
    ``bounded`` lets such a model serve anyway from a 2-slice double
    buffer (the worst adjacent pair of its reload schedule), re-streaming
    the remaining slices through the serial DMA on every decode burst —
    trading DMA bytes for slab headroom, so more tenants fit at tiny
    budgets. Working sets that fit stay fully resident in either mode
    (re-streaming is never free, so the trade is only paid where it buys
    servability). Bounded mode requires layer-granular streaming (the
    double buffer IS the layer prefetch buffer).

    ``quant`` counts weight slices as streamed quantized (per-channel-
    scaled int8 / int4, or the planner's per-layer ``auto`` policy):
    pinned tensors stay bf16 in HBM, but every RELOAD byte — the slab
    working set, the double buffer, the restream traffic — shrinks by the
    encoding's ratio (~1.97x int8, ~3.9x int4). It is byte accounting
    only, as in the reference's pool: no dequant kernel runs on the
    pool's path.
    """
    hbm_budget_bytes: int
    slab_frac: float = 0.35            # budget fraction reserved for swapping
    reload_bytes_per_step: int = 32 * KiB
    hysteresis_steps: int = 32
    param_bytes: int = 2               # bf16 serving copies
    slab_mode: str = "full"            # | "bounded"
    quant: str = "off"                 # | "int8" | "int4" | "auto"
    # route the stream clock through DeviceDmaChannel: every tick copies
    # its bytes from pinned host memory to ``dma_device`` on a stream of
    # its own, so DMA/compute overlap is measured (the copy's event at
    # the next tick) instead of only modeled
    device_dma: bool = False
    dma_device: str = "cuda"

    def __post_init__(self):
        assert self.hbm_budget_bytes >= 0
        assert 0.0 <= self.slab_frac < 1.0
        assert self.reload_bytes_per_step >= 1
        assert self.hysteresis_steps >= 0
        assert self.slab_mode in ("full", "bounded")
        assert self.quant in QUANT_MODES

    @property
    def slab_bytes(self) -> int:
        return int(self.hbm_budget_bytes * self.slab_frac)

    @property
    def pin_budget_bytes(self) -> int:
        return self.hbm_budget_bytes - self.slab_bytes


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One registered model's residency verdict.

    ``value_per_byte`` is the demand-weighted stationarity value of the
    model's average weight byte: demand * (1 + MACs/param). The ``1 +``
    floor makes a hot model's zero-MAC tensors (embeddings) outrank a cold
    model's matmuls — every byte costs the same to reload, so demand alone
    breaks reuse ties.
    """
    model_id: str
    cfg: object
    demand: float
    weight_bytes: int
    pinned_bytes: int
    value_per_byte: float
    fits_slab: bool                    # slab_need <= slab
    layer_bytes: tuple[int, ...] = ()  # full forward-order slice schedule (fp)
    pinned_layer_bytes: tuple[int, ...] = ()   # pinned share per slice (fp)
    slab_need: int = 0                 # slab bytes RESERVED while hot
    precisions: tuple[str, ...] = ()   # per-slice streaming precision
    param_bytes: int = 2

    @property
    def reload_bytes(self) -> int:
        """Bytes fetched over the DMA on each cold activation — the sum
        of the (precision-encoded) reload schedule. Equal to
        ``weight_bytes - pinned_bytes`` when streaming fp."""
        if not self.layer_bytes:
            return self.weight_bytes - self.pinned_bytes
        return sum(self.reload_schedule)

    @property
    def restream_bytes(self) -> int:
        """Bytes a bounded-slab decode burst must re-fetch: everything in
        the reload set beyond what the double buffer keeps resident
        (zero in full mode, where slab_need covers the whole set)."""
        return max(0, self.reload_bytes - self.slab_need)

    @property
    def reload_schedule(self) -> tuple[int, ...]:
        """Per-slice reload bytes in forward order — what a layer-granular
        activation actually moves over the DMA, slice by slice, behind
        compute. Each slice's un-pinned fp bytes are re-encoded at its
        streaming precision (``quant_bytes``): this is the quantity the
        2-slice double buffer and the FIFO see, so compression shrinks
        both without touching the fp packing ledgers."""
        precs = self.precisions or ("fp",) * len(self.layer_bytes)
        return tuple(quant_bytes(f - p, prec, self.param_bytes)
                     for f, p, prec in zip(self.layer_bytes,
                                           self.pinned_layer_bytes, precs))

    def hideable_bytes(self, reload_bytes_per_step: int) -> int:
        """Reload bytes the double-buffered prefetch can hide inside this
        model's own first decode step: while slice k computes (1/n of a
        step, worth ``reload_bytes_per_step / n`` DMA bytes), slice k+1
        streams into the other buffer. Slice 0 can never hide — nothing
        computes ahead of it — so it is excluded; a slice whose reload
        exceeds the per-slice compute budget is a prefetch miss and only
        the covered fraction hides."""
        sched = self.reload_schedule
        if not sched:
            return 0
        budget = reload_bytes_per_step // len(sched)
        return sum(min(b, budget) for b in sched[1:])

    @property
    def residency(self) -> str:
        if self.pinned_bytes >= self.weight_bytes:
            return "resident"
        return "streamed" if self.pinned_bytes > 0 else "evicted"


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    entries: tuple[ModelEntry, ...]
    pcfg: PoolConfig

    def entry(self, model_id: str) -> ModelEntry:
        for e in self.entries:
            if e.model_id == model_id:
                return e
        raise KeyError(f"unknown model {model_id!r}")

    @property
    def pinned_bytes(self) -> int:
        return sum(e.pinned_bytes for e in self.entries)

    def summary(self) -> dict:
        return {
            "budget_KiB": round(self.pcfg.hbm_budget_bytes / KiB, 1),
            "pin_budget_KiB": round(self.pcfg.pin_budget_bytes / KiB, 1),
            "slab_KiB": round(self.pcfg.slab_bytes / KiB, 1),
            "pinned_KiB": round(self.pinned_bytes / KiB, 1),
            "slab_mode": self.pcfg.slab_mode,
            "models": {e.model_id: {
                "residency": e.residency,
                "weight_KiB": round(e.weight_bytes / KiB, 1),
                "pinned_KiB": round(e.pinned_bytes / KiB, 1),
                "reload_KiB": round(e.reload_bytes / KiB, 1),
                "slab_need_KiB": round(e.slab_need / KiB, 1),
                "servable": e.fits_slab,
                "value_per_byte": round(e.value_per_byte, 3),
            } for e in self.entries},
        }


class PoolError(RuntimeError):
    pass


class ModelPool:
    """Residency packing + runtime hot-set tracking for a model zoo.

    Offline: ``register`` models, then ``pack`` pins tensors into the pin
    budget in descending value-per-byte order (skip-and-continue greedy —
    a tensor that doesn't fit is skipped, smaller ones may still pin).

    Online: ``try_activate`` makes a model hot, evicting least-value-first
    under hysteresis, and returns the reload stall; ``note_eviction``
    bookkeeping is internal. Resident models are always hot and never
    evicted.
    """

    def __init__(self, pcfg: PoolConfig):
        self.pcfg = pcfg
        self._specs: dict[str, tuple[object, float]] = {}
        self.plan: PoolPlan | None = None
        # runtime state; the serial DMA (FIFO, clock, reload accounting)
        # lives in one DmaChannel — the streaming methods below are thin
        # delegates kept as the stable WeightStream surface
        self.dma = (DeviceDmaChannel(pcfg.reload_bytes_per_step,
                                     device=pcfg.dma_device)
                    if pcfg.device_dma
                    else DmaChannel(pcfg.reload_bytes_per_step))
        self._hot_since: dict[str, int] = {}   # non-resident hot models
        self.slab_used = 0
        self.deferred_activations = 0
        self.evictions = 0

    # DmaChannel owns the byte counters; these views keep the historical
    # report surface (engine finish_run, bench rows) unchanged.
    @property
    def reload_bytes_total(self) -> int:
        return self.dma.reload_bytes_total

    @property
    def restream_bytes_total(self) -> int:
        return self.dma.restream_bytes_total

    @property
    def reload_events(self) -> int:
        return self.dma.reload_events

    # -- registration / packing --------------------------------------------

    def register(self, model_id: str, cfg, demand: float = 1.0) -> None:
        if self.plan is not None:
            raise PoolError("pool already packed")
        if model_id in self._specs:
            raise PoolError(f"model {model_id!r} registered twice")
        assert demand > 0
        self._specs[model_id] = (cfg, demand)

    @property
    def model_ids(self) -> tuple[str, ...]:
        return tuple(sorted(self._specs))

    def pack(self) -> PoolPlan:
        """Greedy residency packing, highest value-per-byte tensor first."""
        if not self._specs:
            raise PoolError("no models registered")
        pb = self.pcfg.param_bytes
        candidates = []                # (score, model_id, name, bytes)
        totals: dict[str, int] = {}
        values: dict[str, float] = {}
        for mid in self.model_ids:
            cfg, demand = self._specs[mid]
            inv = weight_inventory(cfg)
            totals[mid] = model_weight_bytes(cfg, pb)
            values[mid] = demand * sum(
                t.params * (1.0 + t.reuse) for t in inv) \
                / max(sum(t.params for t in inv), 1)
            for t in inv:
                candidates.append((demand * (1.0 + t.reuse), mid, t.name,
                                   t.params * pb))
        candidates.sort(key=lambda c: (-c[0], c[1], c[2]))

        pinned: dict[str, int] = {mid: 0 for mid in self.model_ids}
        pinned_names: dict[str, set[str]] = {mid: set()
                                             for mid in self.model_ids}
        left = self.pcfg.pin_budget_bytes
        for _score, mid, name, nbytes in candidates:
            if nbytes <= left:
                pinned[mid] += nbytes
                pinned_names[mid].add(name)
                left -= nbytes

        entries = []
        for mid in self.model_ids:
            cfg, demand = self._specs[mid]
            full_slices = layer_schedule(cfg, pb, quant=self.pcfg.quant)
            full_sched = tuple(s.nbytes for s in full_slices)
            pin_sched = tuple(s.nbytes for s in layer_schedule(
                cfg, pb, include=pinned_names[mid]))
            # packing ledgers stay in fp space: pinned tensors live in
            # HBM as bf16 regardless of streaming precision
            assert sum(full_sched) == totals[mid]
            assert sum(pin_sched) == pinned[mid]
            precisions = tuple(s.precision for s in full_slices)
            # ...but everything that MOVES is precision-encoded: the
            # reload schedule, and through it the slab working set
            reload_sched = tuple(
                quant_bytes(f - p, prec, pb)
                for f, p, prec in zip(full_sched, pin_sched, precisions))
            reload = sum(reload_sched)
            # what being hot costs the slab: the whole reload set when it
            # fits (re-streaming is never free, so bounded mode only pays
            # the DMA trade where it buys servability); a tenant whose
            # working set OVERFLOWS the slab falls back to the 2-slice
            # double buffer in bounded mode instead of being refused
            need = reload
            if self.pcfg.slab_mode == "bounded" \
                    and reload > self.pcfg.slab_bytes:
                need = min(reload, double_buffer_bytes(reload_sched))
            entries.append(ModelEntry(
                model_id=mid, cfg=cfg, demand=demand,
                weight_bytes=totals[mid], pinned_bytes=pinned[mid],
                value_per_byte=values[mid],
                fits_slab=need <= self.pcfg.slab_bytes,
                layer_bytes=full_sched, pinned_layer_bytes=pin_sched,
                slab_need=need, precisions=precisions, param_bytes=pb))
        self.plan = PoolPlan(tuple(entries), self.pcfg)
        return self.plan

    # -- runtime hot-set ----------------------------------------------------

    def reset_runtime(self) -> None:
        """Forget the hot set and reload accounting (fresh serving run)."""
        self._hot_since.clear()
        self.dma.reset()
        self.slab_used = 0
        self.deferred_activations = 0
        self.evictions = 0

    def _entry(self, model_id: str) -> ModelEntry:
        if self.plan is None:
            raise PoolError("pack() the pool before serving")
        return self.plan.entry(model_id)

    def is_hot(self, model_id: str) -> bool:
        e = self._entry(model_id)
        return e.residency == "resident" or model_id in self._hot_since

    def hot_models(self) -> list[str]:
        """Every model whose weights are currently in HBM."""
        out = [e.model_id for e in self.plan.entries
               if e.residency == "resident"]
        out += [m for m in sorted(self._hot_since) if m not in out]
        return out

    def reload_stall_steps(self, reload_bytes: int) -> int:
        return -(-reload_bytes // self.dma.bytes_per_step)

    def set_reload_clock(self, bytes_per_step: int) -> None:
        """Deprecation shim over ``dma.set_clock``: re-base the modeled
        DMA bandwidth MID-RUN. Every consumer reads the channel's
        effective clock at use time — stall charging, stream ticks,
        decode-readiness — so the new clock takes effect on the next
        engine step without re-packing; the residency plan itself is
        left alone (placement is a fleet-level decision, pacing is a
        step-level one). Chaos faults should prefer ``dma.degrade``,
        which composes with re-calibration instead of overwriting it;
        ``pcfg`` is kept in sync for legacy readers."""
        self.dma.set_clock(bytes_per_step)
        self.pcfg = dataclasses.replace(
            self.pcfg, reload_bytes_per_step=int(bytes_per_step))

    def servable(self, model_id: str) -> bool:
        return self._entry(model_id).fits_slab

    def evictable(self, step: int, protected: frozenset[str] = frozenset()
                  ) -> list[str]:
        """Hot non-resident models that may be evicted now, least
        value-per-byte first (the paper's spill order, demand-weighted)."""
        out = []
        for mid, since in self._hot_since.items():
            if mid in protected or self.dma.in_flight(mid):
                continue               # never evict a mid-stream reload
            if step - since < self.pcfg.hysteresis_steps:
                continue
            out.append(mid)
        out.sort(key=lambda m: (self._entry(m).value_per_byte, m))
        return out

    def evict(self, model_id: str) -> None:
        since = self._hot_since.pop(model_id, None)
        if since is not None:
            self.slab_used -= self._entry(model_id).slab_need
            self.evictions += 1
        self.finish_stream(model_id)

    def _admit(self, e: ModelEntry, step: int, protected: frozenset[str],
               ) -> list[str] | None:
        """Shared activation path: make room (evicting by policy), mark
        hot, reserve slab space and account the reload bytes. Returns the
        evicted model ids, or None when activation must wait."""
        if not e.fits_slab:
            raise PoolError(
                f"{e.model_id}: slab working set {e.slab_need}B "
                f"exceeds the swap slab ({self.pcfg.slab_bytes}B)")
        evicted: list[str] = []
        need = self.slab_used + e.slab_need - self.pcfg.slab_bytes
        if need > 0:                   # pick victims before touching state
            freed = 0
            for v in self.evictable(step, protected):
                if freed >= need:
                    break
                evicted.append(v)
                freed += self._entry(v).slab_need
            if freed < need:
                self.deferred_activations += 1
                return None
            for v in evicted:
                self.evict(v)
        self._hot_since[e.model_id] = step
        self.slab_used += e.slab_need
        self.dma.charge_reload(e.reload_bytes)
        return evicted

    def try_activate(self, model_id: str, step: int,
                     protected: frozenset[str] = frozenset(),
                     ) -> tuple[int, list[str]] | None:
        """Model-granular activation: make ``model_id`` hot, evicting by
        policy if the slab is full; the whole reload is serial with
        compute. Returns (stall_steps, evicted_model_ids), or None when
        activation must wait (every eviction candidate is protected or
        inside its hysteresis window). Already-hot models are free.
        """
        e = self._entry(model_id)
        if self.is_hot(model_id):
            return 0, []
        evicted = self._admit(e, step, protected)
        if evicted is None:
            return None
        return self.reload_stall_steps(e.reload_bytes), evicted

    # -- layer-granular streaming (WeightStream surface) ---------------------
    #
    # These six methods are thin delegates over ``self.dma`` — the pool
    # contributes only what the channel cannot know: residency entries,
    # slab admission, and the hideable-tail window. They are kept (rather
    # than exposing the channel raw) as the stable WeightStream protocol
    # the engines program against.

    def begin_stream(self, model_id: str, step: int,
                     protected: frozenset[str] = frozenset(),
                     ) -> list[str] | None:
        """Layer-granular activation: reserve slab space for the reload
        working set exactly like ``try_activate``, but charge no up-front
        stall — the layer slices stream in forward order behind compute
        (``stream_tick``), and the engine charges a stall step only when
        it has nothing to overlap the DMA with. The model is hot at once
        but ``decode_ready`` only when the un-streamed tail fits inside
        what its own first forward walk can hide (double-buffered
        prefetch: slice k+1 loads while slice k computes). Returns the
        evicted model ids, or None when activation must wait."""
        e = self._entry(model_id)
        if self.is_hot(model_id):
            return []
        evicted = self._admit(e, step, protected)
        if evicted is None:
            return None
        if e.reload_bytes:
            self.dma.enqueue(model_id, e.reload_bytes)
        return evicted

    @property
    def streaming(self) -> tuple[str, ...]:
        """In-flight layer streams, FIFO order (the DMA is serial)."""
        return self.dma.queue

    @property
    def stream_head(self) -> str | None:
        return self.dma.head

    def stream_remaining(self, model_id: str) -> int:
        return self.dma.remaining(model_id)

    def stream_tick(self, nbytes: int | None = None) -> int:
        """Advance the serial DMA by ``nbytes`` (default: one engine
        step of the channel's EFFECTIVE clock, chaos degradation and
        all), head-of-queue first; finished streams are retired.
        Returns the bytes actually consumed."""
        return self.dma.tick(nbytes)

    def finish_stream(self, model_id: str) -> int:
        """Retire ``model_id``'s in-flight stream without completing it
        (eviction mid-reload, tenant drain). Returns the abandoned
        bytes — already charged as reload traffic when the stream was
        admitted, so dropping them models wasted DMA work, not a
        refund."""
        return self.dma.cancel(model_id)

    def note_decode_burst(self, model_id: str) -> None:
        """Bounded-slab decode burst: the slices beyond the 2-slice double
        buffer were consumed by this step's layer walk and must re-stream
        through the serial DMA FIFO before the tenant's next decode step
        (``decode_ready`` gates on the pending bytes dropping back under
        the hideable window). The re-fetched bytes are charged as reload
        traffic — the DMA-bytes-for-slab-headroom trade made explicit."""
        if self.pcfg.slab_mode != "bounded":
            return
        refetch = self._entry(model_id).restream_bytes
        if refetch <= 0:
            return
        self.dma.enqueue(model_id, refetch)
        self.dma.charge_restream(refetch)

    def decode_ready(self, model_id: str) -> bool:
        """Hot AND either fully streamed, or at the HEAD of the serial
        DMA queue with a tail small enough that the first decode step's
        own layer walk hides it (slice k's compute covers slice k+1's
        fetch). A queued stream behind another model's reload can hide
        nothing — the DMA is busy — so it must wait its turn; the
        hideable tail itself is still charged by the next stream_tick
        (hideable < one step of bandwidth by construction), keeping the
        byte accounting strictly one DMA quantum per engine step."""
        if not self.is_hot(model_id):
            return False
        e = self._entry(model_id)
        return self.dma.ready(
            model_id, e.hideable_bytes(self.dma.bytes_per_step))

    def summary(self) -> dict:
        return {
            "reload_bytes_total": self.reload_bytes_total,
            "restream_bytes_total": self.restream_bytes_total,
            "reload_events": self.reload_events,
            "evictions": self.evictions,
            "deferred_activations": self.deferred_activations,
            "slab_used_KiB": round(self.slab_used / KiB, 1),
            "hot": self.hot_models(),
            "streaming": {m: self.dma.remaining(m) for m in self.dma.queue},
        }
