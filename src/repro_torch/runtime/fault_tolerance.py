"""Shared fault layer, serving half: chaos schedules, straggler
detection and the retry clock.

Port of the serving half of ``repro.runtime.fault_tolerance``, copied as
it is. The fleet tier (runtime.fleet) replicates whole serving pools and
uses these primitives for replica health: the deterministic, seedable
``FaultSchedule`` is the chaos-injection plan (kill / degraded-DMA /
straggler events against named targets), ``StragglerDetector`` is the
rolling-median step-time policy the router reads, and ``Backoff`` is the
deterministic retry clock the fleet uses instead of silent head-of-line
blocking when an admission is refused. ``StepTimeout``,
``TransientFault`` and ``TRANSIENT_DEFAULT`` classify faults for a
control plane. The training supervisor (``ElasticConfig``, ``RunReport``,
``TrainingSupervisor``) needs the checkpoint manager and comes with the
training stack.
"""

from __future__ import annotations

import dataclasses
import statistics


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
