"""Arrival-trace driven scheduling for the continuous-batching engine.

Copy of ``repro.runtime.scheduler`` for the port (the reference's
``repro.runtime`` package imports jax on import).

Time is measured in *engine steps* (one batched decode per step), which
keeps traces deterministic and hardware-independent: a request with
``arrival=k`` becomes visible once the engine has taken k steps. The
scheduler is FCFS for admission; on page exhaustion the engine asks for a
preemption victim and the policy is latest-admitted-first (the youngest
request has the least sunk prefill work — it re-enters the queue head and
re-prefills prompt + generated tokens when pages free up).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""
    rid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int
    arrival: int = 0                   # engine step at which it exists
    extras: dict | None = None         # e.g. vlm patch_embeds (P, D)
    model_id: str = "default"          # pool routing tag (multi-tenant)

    # runtime (owned by the engine)
    generated: list[int] = dataclasses.field(default_factory=list)
    admitted_step: int = -1
    done_step: int = -1
    prefills: int = 0                  # 1 + number of preemption restarts
    truncated: bool = False            # hit the pager's max context
    route_trace: dict | None = None    # MoE first-prefill routing (replay)
    shared_pages: int = 0              # pages admitted by reference
    cow_copies: int = 0                # divergence-write page copies

    @property
    def context_tokens(self) -> np.ndarray:
        """Prompt plus everything generated so far — what a re-admission
        after preemption must prefill (all but the last generated token
        are cache content; the last one is the pending decode input)."""
        gen = np.asarray(self.generated[:-1], np.int32) \
            if len(self.generated) > 1 else np.zeros((0,), np.int32)
        return np.concatenate([self.prompt.astype(np.int32), gen])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens or self.truncated

    @property
    def latency_steps(self) -> int:
        return self.done_step - self.arrival


def poisson_trace(n_requests: int, *, mean_interarrival: float,
                  prompt_lens: tuple[int, ...], gen_lens: tuple[int, ...],
                  vocab_size: int, seed: int = 0, extras_fn=None,
                  model_id: str = "default") -> list[Request]:
    """Mixed-length Poisson trace: exponential interarrival gaps (in
    engine steps), prompt/generation lengths drawn uniformly from the
    given choices. Discrete length choices keep the prefill jit cache
    small (one trace per bucket)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(mean_interarrival)
        plen = int(rng.choice(prompt_lens))
        glen = int(rng.choice(gen_lens))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        out.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=glen, arrival=int(t),
            extras=extras_fn(rng) if extras_fn else None,
            model_id=model_id))
    return out


def shared_prefix_trace(n_requests: int, *, overlap: float,
                        prompt_len: int, mean_interarrival: float,
                        gen_lens: tuple[int, ...], vocab_size: int,
                        seed: int = 0, model_id: str = "default",
                        n_groups: int = 1,
                        resend_frac: float = 0.0) -> list[Request]:
    """Poisson trace whose prompts share a common prefix — the serving
    shape prefix caching exists for (one system prompt / few-shot header
    across a burst of user turns).

    Every prompt is exactly ``prompt_len`` tokens (one prefill jit
    bucket): the leading ``round(overlap * prompt_len)`` tokens are one
    of ``n_groups`` fixed prefixes (assigned round-robin so groups
    interleave in arrival order) and the tail is per-request random.
    ``overlap=0`` degenerates to fully independent prompts of the same
    length — the no-sharing baseline with identical arithmetic.

    ``resend_frac`` of the requests REUSE an earlier prompt verbatim
    (a client re-sending the identical conversation). Under greedy
    decoding such twins follow identical token paths, so a preempted
    twin's re-admission can map a partially occupied page its sibling
    completed — the trace shape that exercises copy-on-write.
    """
    assert 0.0 <= overlap <= 1.0
    rng = np.random.default_rng(seed)
    k = int(round(overlap * prompt_len))
    prefixes = [rng.integers(0, vocab_size, size=k).astype(np.int32)
                for _ in range(max(n_groups, 1))]
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(mean_interarrival)
        if out and rng.random() < resend_frac:
            prompt = out[int(rng.integers(len(out)))].prompt.copy()
        else:
            tail = rng.integers(0, vocab_size, size=prompt_len - k) \
                .astype(np.int32)
            prompt = np.concatenate([prefixes[rid % len(prefixes)], tail])
        out.append(Request(
            rid=rid, prompt=prompt,
            max_new_tokens=int(rng.choice(gen_lens)), arrival=int(t),
            model_id=model_id))
    return out


def _tenant_trace(tenants: Sequence[dict], n_requests: int, *,
                  mean_interarrival: float,
                  prompt_lens: tuple[int, ...],
                  gen_lens: tuple[int, ...], seed: int,
                  probs_for_rid) -> list[Request]:
    """Shared body of the multi-tenant trace generators: one interleaved
    Poisson arrival process whose per-arrival tenant distribution is
    supplied by ``probs_for_rid(rid)``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(mean_interarrival)
        ten = tenants[int(rng.choice(len(tenants), p=probs_for_rid(rid)))]
        plen = int(rng.choice(prompt_lens))
        glen = int(rng.choice(gen_lens))
        prompt = rng.integers(0, ten["vocab_size"], size=plen) \
            .astype(np.int32)
        extras_fn = ten.get("extras_fn")
        out.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=glen, arrival=int(t),
            extras=extras_fn(rng) if extras_fn else None,
            model_id=ten["model_id"]))
    return out


def multi_tenant_trace(tenants: Sequence[dict], n_requests: int, *,
                       mean_interarrival: float,
                       prompt_lens: tuple[int, ...],
                       gen_lens: tuple[int, ...],
                       seed: int = 0) -> list[Request]:
    """One interleaved Poisson arrival process over several tenants.

    ``tenants`` is a list of dicts with keys ``model_id``, ``vocab_size``,
    optional ``share`` (relative traffic weight, default 1.0) and optional
    ``extras_fn``. Each arrival is assigned to a tenant categorically by
    share, so traffic from different models interleaves — the trace shape
    that makes naive weight swapping thrash.
    """
    shares = np.asarray([float(t.get("share", 1.0)) for t in tenants])
    probs = shares / shares.sum()
    return _tenant_trace(tenants, n_requests,
                         mean_interarrival=mean_interarrival,
                         prompt_lens=prompt_lens, gen_lens=gen_lens,
                         seed=seed, probs_for_rid=lambda rid: probs)


def shifting_mix_trace(tenants: Sequence[dict], n_requests: int, *,
                       mean_interarrival: float,
                       prompt_lens: tuple[int, ...],
                       gen_lens: tuple[int, ...],
                       seed: int = 0, flip_frac: float = 0.5
                       ) -> list[Request]:
    """A multi-tenant trace whose traffic mix SHIFTS mid-run: the first
    ``flip_frac`` of the requests draw tenants by the given shares, the
    remainder by the REVERSED share list (the first tenant's weight lands
    on the last, and so on). This is the trace shape a static
    demand-proportional page partition cannot track — the arena's
    load-driven repartitioning is measured against it.
    """
    shares = np.asarray([float(t.get("share", 1.0)) for t in tenants])
    probs = shares / shares.sum()
    flipped = probs[::-1]
    n_first = int(n_requests * flip_frac)
    return _tenant_trace(
        tenants, n_requests, mean_interarrival=mean_interarrival,
        prompt_lens=prompt_lens, gen_lens=gen_lens, seed=seed,
        probs_for_rid=lambda rid: probs if rid < n_first else flipped)


def diurnal_trace(tenants: Sequence[dict], n_requests: int, *,
                  mean_interarrival: float,
                  prompt_lens: tuple[int, ...],
                  gen_lens: tuple[int, ...],
                  seed: int = 0, n_phases: int = 4) -> list[Request]:
    """A multi-tenant trace whose traffic mix ROTATES through
    ``n_phases`` phases: phase p draws tenants by the share vector
    rotated left p times, so every tenant takes a turn as the heavy one
    — the diurnal shape a fleet placement must track (generalizes
    ``shifting_mix_trace``, whose two phases are a special case)."""
    shares = np.asarray([float(t.get("share", 1.0)) for t in tenants])
    per_phase = -(-n_requests // n_phases)
    probs = []
    for p in range(n_phases):
        rolled = np.roll(shares, -p)
        probs.append(rolled / rolled.sum())
    return _tenant_trace(
        tenants, n_requests, mean_interarrival=mean_interarrival,
        prompt_lens=prompt_lens, gen_lens=gen_lens, seed=seed,
        probs_for_rid=lambda rid: probs[min(rid // per_phase,
                                            n_phases - 1)])


class Scheduler:
    """FCFS admission queue over an arrival trace + preemption policy."""

    def __init__(self, requests: list[Request]):
        self._pending = deque(sorted(requests, key=lambda r: r.arrival))
        self._ready: deque[Request] = deque()
        self.preemptions = 0

    # -- arrival handling ---------------------------------------------------

    def release_arrivals(self, step: int) -> None:
        while self._pending and self._pending[0].arrival <= step:
            self._ready.append(self._pending.popleft())

    def next_arrival(self) -> int | None:
        return self._pending[0].arrival if self._pending else None

    # -- admission ----------------------------------------------------------

    def peek_ready(self) -> Request | None:
        return self._ready[0] if self._ready else None

    def pop_ready(self) -> Request:
        return self._ready.popleft()

    def requeue(self, req: Request) -> None:
        """Preempted request: back to the queue head (it keeps priority)."""
        self._ready.appendleft(req)
        self.preemptions += 1

    # -- preemption policy --------------------------------------------------

    @staticmethod
    def pick_victim(active: list[tuple[int, Request]],
                    exclude: int | None = None) -> tuple[int, Request] | None:
        """Latest-admitted active request (slot, request); optionally
        excluding one slot (the one whose growth triggered the hunt)."""
        cands = [(s, r) for s, r in active if s != exclude]
        if not cands:
            cands = [(s, r) for s, r in active]
        if not cands:
            return None
        return max(cands, key=lambda sr: (sr[1].admitted_step, sr[0]))

    @property
    def exhausted(self) -> bool:
        return not self._pending and not self._ready


class MultiQueueScheduler:
    """Per-model FCFS queues over one merged arrival trace.

    Admission stays FCFS *within* a model; across models the pool engine
    chooses which queues are servable (their weights are hot) and this
    scheduler hands out the earliest-arrived ready request among them.
    Preempted requests go back to their model's queue head.
    """

    def __init__(self, requests: list[Request]):
        self._pending = deque(sorted(requests,
                                     key=lambda r: (r.arrival, r.rid)))
        self._ready: dict[str, deque[Request]] = {}
        self.preemptions = 0

    # -- arrival handling ---------------------------------------------------

    def release_arrivals(self, step: int) -> None:
        while self._pending and self._pending[0].arrival <= step:
            r = self._pending.popleft()
            self._ready.setdefault(r.model_id, deque()).append(r)

    def next_arrival(self) -> int | None:
        return self._pending[0].arrival if self._pending else None

    def inject(self, requests: list[Request]) -> None:
        """Add requests mid-run (the fleet router dispatches this way:
        arrivals are stamped with the replica's CURRENT step, so they
        release on the next scan). Pending order stays (arrival, rid)."""
        merged = sorted(list(self._pending) + list(requests),
                        key=lambda r: (r.arrival, r.rid))
        self._pending = deque(merged)

    def drain(self) -> list[Request]:
        """Pull every queued request (ready + pending) out of the
        scheduler — the failover path: a killed replica's queue is
        re-admitted elsewhere. Returns them in (arrival, rid) order."""
        out = [r for q in self._ready.values() for r in q]
        out += list(self._pending)
        self._ready.clear()
        self._pending.clear()
        return sorted(out, key=lambda r: (r.arrival, r.rid))

    # -- admission ----------------------------------------------------------

    def ready_models(self) -> list[str]:
        return sorted(m for m, q in self._ready.items() if q)

    def ready_count(self, model_id: str) -> int:
        return len(self._ready.get(model_id, ()))

    def pending_demand(self, model_id: str) -> int:
        """Decode tokens queued behind ``model_id`` — the activation-value
        numerator for reload-aware admission (tokens bought per reload)."""
        return sum(r.max_new_tokens - len(r.generated)
                   for r in self._ready.get(model_id, ()))

    def ready_heads(self, allowed: Sequence[str]) -> list[Request]:
        """Queue heads of the allowed models, earliest arrival first.
        Admission walks this list so a tenant waiting on its own page
        sub-range does not block its neighbours (FCFS stays per-model)."""
        allowed = set(allowed)
        heads = [q[0] for m, q in self._ready.items()
                 if q and m in allowed]
        heads.sort(key=lambda r: (r.arrival, r.rid))
        return heads

    def peek_ready(self, allowed: Sequence[str]) -> Request | None:
        """Earliest-arrival ready request among the allowed models."""
        heads = self.ready_heads(allowed)
        return heads[0] if heads else None

    def oldest_ready_arrival(self) -> int | None:
        """Earliest arrival step among ALL ready requests (regardless of
        which models are servable right now) — the engine turns this
        into a queued-age signal the fleet router ties on, so a replica
        with a long-stuck head stops winning new traffic on load alone."""
        heads = [q[0] for q in self._ready.values() if q]
        return min((r.arrival for r in heads), default=None)

    def pop_ready(self, req: Request) -> Request:
        got = self._ready[req.model_id].popleft()
        assert got is req, "pop must follow peek"
        return got

    def requeue(self, req: Request) -> None:
        """Preempted request: back to its model's queue head."""
        self._ready.setdefault(req.model_id, deque()).appendleft(req)
        self.preemptions += 1

    @property
    def exhausted(self) -> bool:
        return not self._pending and not any(self._ready.values())
