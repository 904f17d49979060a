"""The serial DRAM->HBM weight-streaming channel, as one object.

Port of ``repro.runtime.dma``: ``WeightStream`` and ``DmaChannel`` are
copied as they are (the modeled FIFO and byte clock every policy
decision runs off); ``DeviceDmaChannel`` moves its ticked bytes from
pinned host memory to the card on a CUDA stream of its own.

Three changes accreted a six-method streaming surface onto ``ModelPool``
(begin/tick/finish, decode gating, restream accounting, the chaos
reload clock). This module consolidates the mutable half of that
surface: ``DmaChannel`` owns the FIFO of in-flight weight streams, the
per-step byte clock, and the reload/restream byte counters, so the
pool, the fleet's ``dma`` chaos fault, and the supervisor's
degraded-link path all mutate ONE object instead of three copies of
the same state. ``ModelPool``'s old methods remain as thin delegates.

The channel is deliberately dumb about *what* it moves: owners are
opaque string ids and byte counts arrive pre-quantized (the planner's
``quant_bytes`` already shrank them), which is exactly why compressed
streaming needed no new channel state — fewer bytes in, same FIFO.
"""

from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import torch

from .. import resolve_device


@runtime_checkable
class WeightStream(Protocol):
    """What an engine relies on to stream weights behind decode.

    ``ModelPool`` satisfies this protocol (its methods are delegates to
    its ``DmaChannel``); anything else that does — a mock, a future
    disaggregated fetcher — can stand in for it in the engine loop.
    """

    def begin_stream(self, model_id: str, step: int,
                     protected: frozenset[str] = ...) -> list[str] | None: ...

    def stream_tick(self, nbytes: int | None = None) -> int: ...

    def finish_stream(self, model_id: str) -> int: ...

    def decode_ready(self, model_id: str) -> bool: ...

    def note_decode_burst(self, model_id: str) -> None: ...

    def set_reload_clock(self, bytes_per_step: int) -> None: ...


class DmaChannel:
    """Serial DMA FIFO + clock + reload accounting.

    The channel moves at most ``bytes_per_step`` bytes per engine step
    (``tick``), strictly head-of-queue first — the DRAM interface is one
    serial resource, the §2.2 premise. ``degrade`` models a chaos
    ``dma`` fault: the effective clock is ``base // factor`` and is
    restored by ``degrade(1.0)``, so fleet chaos and the supervisor's
    degraded-link path share the mechanism.
    """

    def __init__(self, bytes_per_step: int):
        assert bytes_per_step >= 1
        self.base_bytes_per_step = int(bytes_per_step)
        self.bytes_per_step = int(bytes_per_step)
        self.degrade_factor = 1.0
        self._q: list[str] = []            # FIFO of in-flight streams
        self._left: dict[str, int] = {}    # owner -> bytes outstanding
        self.reload_bytes_total = 0
        self.restream_bytes_total = 0
        self.reload_events = 0

    # -- queries ------------------------------------------------------------

    @property
    def queue(self) -> tuple[str, ...]:
        return tuple(self._q)

    @property
    def head(self) -> str | None:
        return self._q[0] if self._q else None

    def remaining(self, owner: str) -> int:
        return self._left.get(owner, 0)

    def in_flight(self, owner: str) -> bool:
        return owner in self._left

    def ready(self, owner: str, hideable_bytes: int) -> bool:
        """Drained, or at the FIFO head with a tail the owner's own next
        compute walk can hide. A stream queued behind another owner's
        can hide nothing — the serial channel is busy."""
        left = self._left.get(owner, 0)
        if left == 0:
            return True
        if self._q[0] != owner:
            return False
        return left <= hideable_bytes

    # -- mutators (RA302-guarded: each must be exercised by a test that
    # -- asserts check()) ---------------------------------------------------

    def enqueue(self, owner: str, nbytes: int) -> None:
        """Add ``nbytes`` to ``owner``'s in-flight stream, appending it
        to the FIFO tail if it has none (re-entering the queue keeps the
        serial-channel ordering honest — a restream waits behind every
        reload already in flight)."""
        nbytes = int(nbytes)
        assert nbytes > 0
        if owner not in self._left:
            self._q.append(owner)
            self._left[owner] = 0
        self._left[owner] += nbytes

    def cancel(self, owner: str) -> int:
        """Drop ``owner``'s in-flight stream (eviction mid-reload).
        Returns the bytes abandoned (0 if none were in flight)."""
        left = self._left.pop(owner, 0)
        if owner in self._q:
            self._q.remove(owner)
        return left

    def tick(self, nbytes: int | None = None) -> int:
        """Advance the channel by ``nbytes`` (default: one step of the
        effective clock), head-of-queue first; finished streams are
        retired. Returns the bytes actually moved."""
        nbytes = self.bytes_per_step if nbytes is None else int(nbytes)
        used = 0
        while self._q and nbytes > 0:
            m = self._q[0]
            take = min(self._left[m], nbytes)
            self._left[m] -= take
            nbytes -= take
            used += take
            if self._left[m] == 0:
                self._q.pop(0)
                del self._left[m]
        return used

    def charge_reload(self, nbytes: int) -> None:
        """Account one cold activation's reload traffic (model-granular
        activations charge here without enqueueing: their whole stall is
        taken up front)."""
        assert nbytes >= 0
        if nbytes:
            self.reload_bytes_total += int(nbytes)
            self.reload_events += 1

    def charge_restream(self, nbytes: int) -> None:
        """Account bounded-slab re-fetch traffic — the DMA-bytes-for-
        slab-headroom trade made explicit. Counted in BOTH totals (a
        restream byte is a reload byte that the slab chose not to keep)
        but never as a reload event."""
        assert nbytes >= 0
        if nbytes:
            self.reload_bytes_total += int(nbytes)
            self.restream_bytes_total += int(nbytes)

    def set_clock(self, bytes_per_step: int) -> None:
        """Re-base the configured clock; any degrade factor in force is
        re-applied on top (chaos survives a re-calibration)."""
        assert bytes_per_step >= 1
        self.base_bytes_per_step = int(bytes_per_step)
        self._apply_clock()

    def degrade(self, factor: float) -> None:
        """Degraded-link fault: the effective clock becomes
        ``base // factor`` (floored at 1 byte/step). ``degrade(1.0)``
        restores full bandwidth."""
        assert factor >= 1.0
        self.degrade_factor = float(factor)
        self._apply_clock()

    def reset(self) -> None:
        """Fresh serving run: drop in-flight streams and counters; the
        clock (base and degrade factor) is left as configured."""
        self._q.clear()
        self._left.clear()
        self.reload_bytes_total = 0
        self.restream_bytes_total = 0
        self.reload_events = 0

    def _apply_clock(self) -> None:
        self.bytes_per_step = max(
            1, int(self.base_bytes_per_step // self.degrade_factor))

    # -- invariants ---------------------------------------------------------

    def check(self) -> None:
        """Structural invariants; raises AssertionError on violation."""
        assert len(self._q) == len(set(self._q)), "duplicate FIFO entries"
        assert set(self._q) == set(self._left), "FIFO/ledger disagree"
        assert all(v >= 0 for v in self._left.values()), "negative stream"
        assert self.reload_bytes_total >= self.restream_bytes_total >= 0
        assert self.reload_events >= 0
        assert self.bytes_per_step >= 1 and self.base_bytes_per_step >= 1
        assert self.degrade_factor >= 1.0
        assert self.bytes_per_step <= self.base_bytes_per_step


class DeviceDmaChannel(DmaChannel):
    """DmaChannel whose ticks also move REAL bytes to the device.

    The modeled ledger (FIFO, byte clock, reload counters) is inherited
    unchanged: every policy decision still runs off it, so swapping this
    channel in changes no scheduling. On top of it, each ``tick`` that
    moves bytes copies them from a pinned host buffer into one of two
    uint8 slabs on ``device`` (alternating), with ``non_blocking=True``
    on the channel's own ``torch.cuda.Stream``, and records an event
    after the copy. The clock models the off-chip reload path, which on
    the card is the host link, so each ticked byte crosses the link the
    ledger charges for. At the next tick the channel queries that event
    (``jax.Array.is_ready`` in the reference): if the copy is still
    running it waits for it and counts a measured stall and its seconds.
    An engine with decode work between ticks gives the copy wall time to
    finish behind the decode; one that ticks back to back on a prefetch
    miss does not, so measured stalls line up with, and are bounded by,
    the steps the modeled ledger charges as stalls.

    A tick never runs while a CUDA graph is being captured (the engine
    ticks between its dispatches). On the CPU the copy is synchronous and
    no stall is ever counted.
    """

    def __init__(self, bytes_per_step: int, slab_bytes: int | None = None,
                 device="cuda"):
        super().__init__(bytes_per_step)
        self.device = resolve_device(device)
        n = max(1, int(slab_bytes if slab_bytes is not None
                       else bytes_per_step))
        self.slab_bytes = n
        cuda = self.device.type == "cuda"
        self._slabs = [torch.zeros((n,), dtype=torch.uint8,
                                   device=self.device) for _ in range(2)]
        self._host = torch.empty((n,), dtype=torch.uint8,
                                 pin_memory=cuda).fill_(1)
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._cursor = 0
        self._inflight = None          # the previous tick's copy event
        self.copies_issued = 0
        self.copied_bytes = 0
        self.measured_stall_steps = 0
        self.measured_wait_s = 0.0

    def tick(self, nbytes: int | None = None) -> int:
        used = super().tick(nbytes)
        if used <= 0:
            return used
        prev = self._inflight
        if prev is not None and not prev.query():
            # the previous copy outlived its step: a REAL stall, measured
            # at the same granularity the ledger models
            t0 = time.perf_counter()
            prev.synchronize()
            self.measured_wait_s += time.perf_counter() - t0
            self.measured_stall_steps += 1
        self._cursor ^= 1
        self.copies_issued += 1
        n = min(used, self.slab_bytes)
        self.copied_bytes += n
        dst, src = self._slabs[self._cursor][:n], self._host[:n]
        if self._stream is None:
            dst.copy_(src)
            return used
        assert not torch.cuda.is_current_stream_capturing(), \
            "a DMA tick inside a CUDA-graph capture"
        done = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            # the slab was last written two ticks ago, on this stream
            dst.copy_(src, non_blocking=True)
            done.record(self._stream)
        dst.record_stream(self._stream)
        self._inflight = done
        return used

    def reset(self) -> None:
        super().reset()
        if self._inflight is not None:
            self._inflight.synchronize()
        self._inflight = None
        self.copies_issued = 0
        self.copied_bytes = 0
        self.measured_stall_steps = 0
        self.measured_wait_s = 0.0

    def check(self) -> None:
        super().check()
        assert 0 <= self.measured_stall_steps <= self.copies_issued
        assert self.measured_wait_s >= 0.0
        assert self.slab_bytes >= 1
        assert all(s.shape == (self.slab_bytes,) for s in self._slabs)
