"""Shared fault layer: chaos schedules, straggler detection, the retry
clock, and the fault-tolerant training supervisor.

Port of ``repro.runtime.fault_tolerance``, copied as it is. The fleet
tier (runtime.fleet) replicates whole serving pools and uses these
primitives for replica health: the deterministic, seedable
``FaultSchedule`` is the chaos-injection plan (kill / degraded-DMA /
straggler events against named targets), ``StragglerDetector`` is the
rolling-median step-time policy the router reads, and ``Backoff`` is the
deterministic retry clock the fleet uses instead of silent head-of-line
blocking when an admission is refused. ``StepTimeout``,
``TransientFault`` and ``TRANSIENT_DEFAULT`` classify faults for a
control plane.

The training supervisor (``ElasticConfig``, ``RunReport``,
``TrainingSupervisor``) wraps a step function with the reference's
policies: periodic checkpoints with atomic publish (the port's
``CheckpointManager``); fault classification — a transient fault
(``TransientFault``, ``StepTimeout``, timeouts, an injected ``kill``) is
retried from the last checkpoint until the elastic shrink engages after
``max_retries`` in a row, a permanent error gets one restore attempt and
re-raises on recurrence; straggler detection against the rolling median
(optionally restarting); and the ``on_shrink`` hook that rebuilds the
step for fewer replicas (the data pipeline is step-indexed, so no sample
is lost or repeated). Under a mesh every rank runs the supervisor and
takes the same decisions (``TrainingSupervisor``'s ``mesh``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections.abc import Callable
from typing import Any

import torch

from ..checkpoint import CheckpointManager
from .dma import DmaChannel


class StepTimeout(RuntimeError):
    """Raised by the step wrapper when a straggler policy aborts a step."""


class TransientFault(RuntimeError):
    """A fault the control plane should retry: host preemption, link
    flap, an injected chaos kill. Deterministic errors (shape bugs,
    assertions) must NOT subclass this — they re-raise after one
    restore attempt instead of looping through the retry budget."""


#: Default transient-exception allowlist. RuntimeError/ValueError at
#: large are deliberately NOT here: a deterministic bug raised every
#: step used to be retried until the shrink path fired, hiding it.
TRANSIENT_DEFAULT: tuple[type[BaseException], ...] = (
    StepTimeout, TransientFault, TimeoutError, ConnectionError)


# --- chaos schedule ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault. ``step`` is the consumer's own clock (engine
    steps for training, fleet ticks for serving). ``target`` names the
    victim: replica ids ("r0", "r1", ...) for the fleet, "train" for the
    supervisor. ``kind``:

      * ``kill``     — the target dies at ``step`` (permanent; the fleet
                       drains and re-admits its tenants, the supervisor
                       sees a TransientFault);
      * ``dma``      — the target's reload clock is cut by ``factor`` for
                       ``duration`` steps (degraded DRAM->HBM link);
      * ``straggle`` — the target's step time inflates by ``factor`` for
                       ``duration`` steps.
    """
    step: int
    kind: str                          # kill | dma | straggle
    target: str
    factor: float = 1.0
    duration: int = 0                  # steps the effect lasts (kill: n/a)

    def __post_init__(self):
        assert self.kind in ("kill", "dma", "straggle"), self.kind
        assert self.step >= 0
        assert self.factor >= 1.0
        assert self.duration >= 0

    def active(self, step: int) -> bool:
        """Is a windowed (dma/straggle) effect live at ``step``?"""
        if self.kind == "kill":
            return step >= self.step
        return self.step <= step < self.step + self.duration

    @property
    def spec(self) -> str:
        s = f"{self.kind}@{self.step}:{self.target}"
        if self.kind != "kill":
            s += f"x{self.factor:g}/{self.duration}"
        return s


class FaultSchedule:
    """A deterministic, immutable chaos plan — the same object drives the
    fleet router and the training supervisor, so a chaos scenario is one
    artifact.

    Spec grammar (``parse``): comma-separated events,
    ``kind@step:target[xfactor][/duration]`` — e.g.
    ``"kill@120:r1,dma@200:r0x4/100,straggle@300:r2x3/50"``.
    """

    def __init__(self, events: list[FaultEvent] | tuple[FaultEvent, ...]
                 = ()):
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind, e.target)))

    # -- constructors -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        events = []
        for item in filter(None, (s.strip() for s in spec.split(","))):
            head, _, rest = item.partition("@")
            at, _, tgt = rest.partition(":")
            factor, duration = 1.0, 0
            if "/" in tgt:
                tgt, _, dur = tgt.partition("/")
                duration = int(dur)
            if "x" in tgt:
                tgt, _, fac = tgt.partition("x")
                factor = float(fac)
            if head != "kill" and duration == 0:
                raise ValueError(
                    f"{item!r}: {head} events need a /duration")
            events.append(FaultEvent(step=int(at), kind=head, target=tgt,
                                     factor=factor, duration=duration))
        return cls(events)

    @classmethod
    def random(cls, seed: int, *, n_events: int, horizon: int,
               targets: tuple[str, ...],
               kinds: tuple[str, ...] = ("kill", "dma", "straggle"),
               max_kills: int | None = None) -> "FaultSchedule":
        """Seeded random plan (same seed => identical schedule). At most
        ``max_kills`` (default: len(targets) - 1) targets die, so the
        fleet always keeps a survivor."""
        import numpy as np

        rng = np.random.default_rng(seed)
        if max_kills is None:
            max_kills = max(len(targets) - 1, 0)
        events, killed = [], set()
        for _ in range(n_events):
            kind = str(rng.choice(kinds))
            tgt = str(rng.choice(targets))
            if kind == "kill" and (tgt in killed
                                   or len(killed) >= max_kills):
                kind = "straggle"
            if kind == "kill":
                killed.add(tgt)
            events.append(FaultEvent(
                step=int(rng.integers(1, horizon)), kind=kind, target=tgt,
                factor=1.0 if kind == "kill"
                else float(rng.integers(2, 6)),
                duration=0 if kind == "kill"
                else int(rng.integers(horizon // 8, horizon // 2))))
        return cls(events)

    # -- queries ------------------------------------------------------------

    def events_at(self, step: int, target: str | None = None
                  ) -> list[FaultEvent]:
        """Events FIRING exactly at ``step`` (effect onsets)."""
        return [e for e in self.events if e.step == step
                and (target is None or e.target == target)]

    def factor(self, kind: str, target: str, step: int) -> float:
        """Combined inflation factor of the windowed effects of ``kind``
        live on ``target`` at ``step`` (1.0 when none)."""
        f = 1.0
        for e in self.events:
            if e.kind == kind and e.target == target and e.active(step):
                f *= e.factor
        return f

    def killed(self, target: str, step: int) -> bool:
        return any(e.kind == "kill" and e.target == target
                   and e.active(step) for e in self.events)

    @property
    def spec(self) -> str:
        return ",".join(e.spec for e in self.events)

    def __bool__(self) -> bool:
        return bool(self.events)


# --- retry / health primitives ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Deterministic exponential backoff clock, in consumer steps. The
    fleet charges ``delay(attempt)`` steps between admission retries
    instead of blocking the queue head; determinism keeps chaos runs
    replayable (same seed => same re-admission order)."""
    base: int = 1
    factor: float = 2.0
    cap: int = 16

    def delay(self, attempt: int) -> int:
        """Steps to wait after the ``attempt``-th refusal (0-indexed)."""
        return min(int(self.base * self.factor ** attempt), self.cap)


class StragglerDetector:
    """Rolling-median step-time policy, shared by the training supervisor
    (wall-clock durations) and the fleet router (MODELED step durations,
    so chaos runs stay deterministic): a step exceeding ``factor`` x the
    median of the last ``window`` durations is flagged."""

    def __init__(self, factor: float = 3.0, window: int = 16):
        self.factor = factor
        self.window = window
        self._durations: list[float] = []

    def observe(self, dt: float) -> bool:
        """Record a step duration; True if it trips the policy."""
        recent = self._durations[-self.window:]
        is_straggler = (len(recent) >= 4
                        and dt > self.factor * statistics.median(recent))
        self._durations.append(dt)
        return is_straggler

    def median(self) -> float | None:
        """Rolling median of the current window (None until 4 samples).
        Lets a caller judge the stream against an EXTERNAL baseline —
        self-relative detection (observe) can never flag a uniformly
        slow stream, because its own median inflates with it. The fleet
        compares each replica's median advance gap against the modeled
        pace of 1 step/tick."""
        recent = self._durations[-self.window:]
        if len(recent) < 4:
            return None
        return statistics.median(recent)


# --- training supervisor ----------------------------------------------------------


@dataclasses.dataclass
class ElasticConfig:
    checkpoint_every: int = 50
    max_retries: int = 3                # consecutive failures before shrink
    straggler_factor: float = 3.0       # x rolling median
    straggler_window: int = 16
    straggler_restart: bool = False     # restart on straggler (vs log only)
    #: transient-exception allowlist — everything else is PERMANENT and
    #: re-raises after one restore attempt instead of retry-until-shrink
    transient: tuple[type[BaseException], ...] = TRANSIENT_DEFAULT


@dataclasses.dataclass
class RunReport:
    steps_done: int
    retries: int
    restores: int
    shrinks: int
    stragglers: list[int]
    final_metrics: dict[str, Any]
    transient_faults: int = 0
    permanent_faults: int = 0
    #: per-fault classification: {"step", "kind", "error"}
    fault_log: list[dict] = dataclasses.field(default_factory=list)


class TrainingSupervisor:
    def __init__(self, manager: CheckpointManager,
                 cfg: ElasticConfig | None = None, *,
                 on_shrink: Callable[[int], Any] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 faults: FaultSchedule | None = None,
                 dma: DmaChannel | None = None, mesh=None):
        """``mesh`` (``launch.mesh``): every rank of a mesh of more than
        one rank runs this loop, and all must take the same decisions,
        or one waits forever in a collective. The injected faults are the
        same on every rank (one schedule); a step's duration is the
        slowest rank's (an all-reduce of the max), so the straggler
        verdict agrees; restores load the step rank 0 sees and saves
        gather the slices (the manager's ``specs``/``mesh``)."""
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.mgr = manager
        self.cfg = cfg or ElasticConfig()
        self.on_shrink = on_shrink
        self.clock = clock
        self.faults = faults or FaultSchedule()
        #: optional weight-streaming channel: injected ``dma`` chaos
        #: events degrade its clock for their window (the same DmaChannel
        #: object the serving fleet's replicas mutate), restoring to full
        #: bandwidth when no event is live
        self.dma = dma
        self._detector = StragglerDetector(self.cfg.straggler_factor,
                                           self.cfg.straggler_window)
        self._fired: set[FaultEvent] = set()

    # -- main loop ---------------------------------------------------------------

    def run(self, state, step_fn: Callable, batch_fn: Callable, *,
            start_step: int, num_steps: int) -> tuple[Any, RunReport]:
        """Drive ``state = step_fn(state, batch_fn(step))`` with recovery.

        step_fn returns (state, metrics). state must be restorable via the
        checkpoint manager (a pytree). Exceptions are CLASSIFIED against
        ``cfg.transient``: transient faults retry (restoring from the last
        checkpoint) and escalate to the elastic shrink after
        ``max_retries`` consecutive hits; a permanent error gets one
        restore attempt — the failure may have been corrupted state — and
        re-raises if it strikes again (or no checkpoint exists).
        """
        report = RunReport(0, 0, 0, 0, [], {})
        step = start_step
        consecutive = 0
        permanent_attempted = False
        metrics: dict[str, Any] = {}

        while step < start_step + num_steps:
            t0 = self.clock()
            try:
                if self.dma is not None:
                    self.dma.degrade(
                        max(1.0, self.faults.factor("dma", "train", step)))
                for ev in self.faults.events_at(step, "train"):
                    if ev.kind == "kill" and ev not in self._fired:
                        self._fired.add(ev)
                        raise TransientFault(f"injected {ev.spec}")
                state, metrics = step_fn(state, batch_fn(step))
                dt = (self.clock() - t0) \
                    * self.faults.factor("straggle", "train", step)
                if self.mesh is not None:        # the slowest rank's
                    dt = float(self.mesh.all_reduce(torch.tensor(
                        [dt], dtype=torch.float64, device=self.mesh.device),
                        self.mesh.axis_names, op="max"))
                if self._detector.observe(dt):
                    report.stragglers.append(step)
                    if self.cfg.straggler_restart:
                        raise StepTimeout(
                            f"step {step}: {dt:.3f}s > "
                            f"{self.cfg.straggler_factor}x median")
            except Exception as e:  # noqa: PERF203, BLE001 — classified below
                transient = isinstance(e, self.cfg.transient)
                report.retries += 1
                report.fault_log.append({
                    "step": step,
                    "kind": "transient" if transient else "permanent",
                    "error": repr(e)})
                if transient:
                    report.transient_faults += 1
                    consecutive += 1
                    if consecutive > self.cfg.max_retries:
                        if self.on_shrink is None:
                            raise
                        # elastic shrink: rebuild mesh/step_fn, resume
                        step_fn, batch_fn = self.on_shrink(step)
                        report.shrinks += 1
                        consecutive = 0
                else:
                    report.permanent_faults += 1
                    # a deterministic error earns ONE restore attempt
                    # (the fault may have been corrupted state); on
                    # recurrence — or with nothing to restore — re-raise
                    # instead of spending the retry budget on a bug
                    if permanent_attempted \
                            or self.mgr.latest_step() is None:
                        raise
                    permanent_attempted = True
                if self.mgr.latest_step() is not None:
                    state, ck = self.mgr.restore(state)
                    step = ck
                    report.restores += 1
                continue

            consecutive = 0
            step += 1
            report.steps_done += 1
            if step % self.cfg.checkpoint_every == 0:
                self.mgr.save(step, state, extra={"metrics": {
                    k: float(v) for k, v in metrics.items()
                    if hasattr(v, "__float__")}})

        report.final_metrics = metrics
        return state, report
