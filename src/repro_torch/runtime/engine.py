"""Continuous-batching decode engine (port of the dense, vlm, ssm, hybrid
and MLA-MoE paths of ``repro.runtime.engine``), and the static lockstep path,
which also serves the families with no engine backend (GQA-MoE olmoe,
the whisper encoder-decoder), as in the reference.

The static path (``run_static``) prefills one lockstep batch and decodes
until the longest request finishes, holding a dense ``batch x max_len``
cache. The engine keeps every slot busy instead:

  * an admission queue (scheduler.py) feeds free slots as requests arrive;
  * each slot advances its own request at its own length (per-slot RoPE
    positions and attention lengths, transformer.paged_decode_step);
  * the KV cache is a shared page pool (kv_pager.py) addressed through
    int32 page tables, so cache bytes track live tokens (per-head K/V for
    the dense family, one latent row a token for MLA-MoE);
  * finished slots are recycled at once and their pages returned;
  * on page exhaustion the youngest request is preempted (pages freed,
    request requeued) rather than stalling the whole batch;
  * with prefix sharing (dense only), admission maps prompt prefixes
    already in the pool onto refcounted pages and copies a shared page on
    its first divergent write;
  * the recurrent backend (ssm, rwkv6) holds no pages: each slot owns a
    constant-size state, written in place at admission, so the loop runs
    without allocator, page table growth or prefill bucketing;
  * the hybrid backend (recurrentgemma) holds a constant recurrent state
    per slot plus its attention window's KV in a page ring: a slot maps at
    most ``ring_rows`` pages, and each page boundary past the ring frees
    the page that slid out of the window into the row it reuses;
  * a routed (MoE) backend records each request's expert-drop population
    at its first prefill and replays it at every re-prefill, so
    preemption never changes a request's tokens.

Decode runs in fused horizons: one ``decode_fused`` call advances up to
``horizon`` steps on the device with greedy argmax there, and the host
syncs once per horizon. On the card a horizon is h replays of a CUDA
graph of the decode step (decode_graph.py); on the CPU the eager loop.
The schedule, and so every count the report keeps, is the reference's
step for step.

``PooledEngine`` (a port of the reference's) serves a model zoo from one
card: one backend a tenant (its own KV pool and decode graph), the
tenants' pages leased from one ``DeviceArena``, their slots in one
``DeviceLoopState``, weight reloads charged by the ``ModelPool``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import get_model
from ..models import griffin as G
from ..models import layers as L
from ..models import moe as MoE
from ..models import rwkv6 as R
from ..models import transformer as T
from .arena import ArenaConfig, DeviceArena
from .decode_graph import DecodeGraph
from .device_state import DeviceLoopState
from .kv_pager import TRASH_PAGE, PageAllocator, PagerConfig
from .model_pool import ModelPool
from .prefix_index import PrefixIndex
from .scheduler import MultiQueueScheduler, Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 8
    page_size: int = 16
    num_pages: int = 257               # incl. the trash page
    max_pages_per_seq: int = 16
    prefill_bucket: int = 32           # prompt pad quantum (page multiple)
    greedy: bool = True
    temperature: float = 0.8
    seed: int = 0
    max_steps: int = 200_000
    # cross-request KV prefix sharing (radix index over token ids,
    # refcounted shared pages, copy-on-write at the first divergent write)
    prefix_sharing: bool = False
    # cap on the decode steps one fused dispatch may advance (the engine
    # shrinks it so no schedulable event lands mid-horizon); 1 keeps the
    # per-step dispatch, and non-greedy sampling always runs per step
    horizon: int = 32

    def __post_init__(self):
        assert self.prefill_bucket % self.page_size == 0, \
            "prefill bucket must be a page multiple"
        assert self.horizon >= 1

    @property
    def pager(self) -> PagerConfig:
        return PagerConfig(self.num_pages, self.page_size,
                           self.max_pages_per_seq)


# --- sampling and reports --------------------------------------------------------


def make_batch_sampler(rng: np.random.Generator, greedy: bool,
                       temperature: float):
    """Host-side batch sampler shared by the engine and the static
    baseline. Greedy argmaxes the (N, V) block; the temperature path
    draws ONE uniform per row and inverts the softmax CDF, so a seeded
    run is deterministic."""
    def sample_batch(rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None]
        if rows.shape[0] == 0:
            return np.zeros((0,), np.int64)
        if greedy:
            return np.argmax(rows, axis=-1)
        z = rows.astype(np.float64) / temperature
        z -= z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        cdf = np.cumsum(p, axis=-1)
        u = rng.random(rows.shape[0]) * cdf[:, -1]
        return np.minimum((cdf < u[:, None]).sum(axis=-1),
                          rows.shape[-1] - 1)
    return sample_batch


def _charge_wall(rep, seen: set, key, dt: float) -> None:
    """Charge ``dt`` for one decode dispatch: the first dispatch of each
    kind pays the kernels' build and warm-up, so it lands in
    ``compile_wall_s`` and every later one in ``decode_wall_s``."""
    if key in seen:
        rep.decode_wall_s += dt
    else:
        seen.add(key)
        rep.compile_wall_s += dt


@dataclasses.dataclass
class EngineReport:
    name: str
    num_slots: int
    decode_steps: int = 0
    slot_steps: int = 0                # actual batch width summed per step
    useful_slot_steps: int = 0
    prefill_calls: int = 0
    prefill_tokens: int = 0            # computed (padded) prefill tokens
    preemptions: int = 0
    completed: list[Request] = dataclasses.field(default_factory=list)
    peak_live_pages: int = 0
    shared_page_hits: int = 0          # pages admitted by reference
    cow_copies: int = 0                # divergence-write page copies
    prefill_tokens_saved: int = 0      # bucketed tokens NOT recomputed
    peak_demand_pages: int = 0         # live minus index-only cache
    page_bytes: int = 0                # 0 -> non-paged backend or static
    slot_state_bytes: int = 0          # per-slot non-paged state
    cache_bytes_alloc: int = 0         # full backing allocation
    wall_s: float = 0.0
    decode_wall_s: float = 0.0         # steady state (see _charge_wall)
    compile_wall_s: float = 0.0
    prefill_wall_s: float = 0.0        # host clock around each prefill
    # decode-loop host<->device traffic (prefill excluded)
    device_dispatches: int = 0
    host_syncs: int = 0
    page_table_upload_bytes: int = 0

    @property
    def new_tokens(self) -> int:
        return sum(len(r.generated) for r in self.completed)

    @property
    def prefill_equiv_steps(self) -> float:
        """Prefill compute in decode-step units (T computed prefill tokens
        occupy ~T/num_slots steps); re-prefill after preemption counts."""
        return self.prefill_tokens / max(self.num_slots, 1)

    @property
    def decode_tokens_per_step(self) -> float:
        return self.new_tokens / max(self.decode_steps, 1)

    @property
    def tokens_per_step(self) -> float:
        """Generated tokens per decode-equivalent step, prefill included."""
        return self.new_tokens / max(
            self.decode_steps + self.prefill_equiv_steps, 1.0)

    @property
    def wasted_slot_fraction(self) -> float:
        return 1.0 - self.useful_slot_steps / max(self.slot_steps, 1)

    @property
    def kv_bytes_peak(self) -> int:
        """Peak cache bytes holding live tokens (paged, plus any per-slot
        state) or the full allocation (static, recurrent)."""
        if self.page_bytes:
            return (self.peak_live_pages * self.page_bytes
                    + self.slot_state_bytes)
        return self.cache_bytes_alloc

    @property
    def kv_demand_bytes_peak(self) -> int:
        """Peak cache bytes some request references (shared pages once,
        index-only warm cache excluded)."""
        if self.page_bytes:
            return (self.peak_demand_pages * self.page_bytes
                    + self.slot_state_bytes)
        return self.cache_bytes_alloc

    def latency_percentiles(self, qs=(50, 95)) -> dict[str, float]:
        lats = [r.latency_steps for r in self.completed] or [0]
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def summary(self) -> dict:
        return {
            "name": self.name,
            "requests": len(self.completed),
            "new_tokens": self.new_tokens,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            "tokens_per_step": round(self.tokens_per_step, 3),
            "decode_tokens_per_step": round(self.decode_tokens_per_step, 3),
            "wasted_slot_fraction": round(self.wasted_slot_fraction, 3),
            "kv_bytes_peak": self.kv_bytes_peak,
            "kv_demand_bytes_peak": self.kv_demand_bytes_peak,
            "shared_page_hits": self.shared_page_hits,
            "cow_copies": self.cow_copies,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "preemptions": self.preemptions,
            "prefill_calls": self.prefill_calls,
            **{k: round(v, 1)
               for k, v in self.latency_percentiles().items()},
            "wall_s": round(self.wall_s, 3),
            "decode_wall_s": round(self.decode_wall_s, 4),
            "compile_wall_s": round(self.compile_wall_s, 4),
            "prefill_wall_s": round(self.prefill_wall_s, 4),
            "device_dispatches": self.device_dispatches,
            "host_syncs": self.host_syncs,
            "page_table_upload_bytes": self.page_table_upload_bytes,
            "tokens_per_s": round(self.new_tokens / self.decode_wall_s, 1)
            if self.decode_wall_s > 0 else 0.0,
        }


def _host(t) -> np.ndarray:
    """Device tensor -> numpy (a host sync)."""
    return t.float().cpu().numpy() if t.is_floating_point() \
        else t.cpu().numpy()


def _state_bytes(state) -> int:
    """Bytes of a cache state's dataclass fields (or of a tuple of
    tensors), as the reference counts its state's leaves: every tensor
    (caches, whisper's encoder output), and an int position as the
    reference's int32 scalar."""
    leaves = state if isinstance(state, tuple) else [
        getattr(state, f.name) for f in dataclasses.fields(state)]
    total = 0
    for v in leaves:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, int):
            total += 4
    return total


def vlm_extras_fn(cfg, num_patches: int = 4):
    """Per-request extras of a vlm trace (a ``poisson_trace`` hook): the
    stub vision frontend's patch embeddings (num_patches, d_model) f32,
    drawn from the trace's rng."""
    def extras(rng: np.random.Generator) -> dict:
        return {"patch_embeds": rng.standard_normal(
            (num_patches, cfg.d_model)).astype(np.float32)}
    return extras


def encdec_extras_fn(cfg):
    """Per-request extras of an encoder-decoder trace (a ``poisson_trace``
    hook): the stub frontend's frame embeddings (T_enc, d_model) f32,
    drawn from the trace's rng."""
    def extras(rng: np.random.Generator) -> dict:
        return {"frames": rng.standard_normal(
            (cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)}
    return extras


# --- backends ------------------------------------------------------------------
# The engine drives a backend through the reference's protocol:
#   paged             -- does the backend allocate KV pages at all
#   ring_rows         -- None for linear page-table growth (the cache grows
#                        with the context), or R for a page-granular window
#                        ring (a slot holds at most R pages; on a wrap the
#                        engine frees the page that slid out of the window)
#   page_bytes        -- bytes one page holds across layers (0 if unpaged)
#   slot_state_bytes  -- bytes of the non-paged per-slot state
#   routed            -- records/replays MoE drop masks across preemption
#   prefix_sharing    -- may map shared prompt pages (dense only)
#   can_ever_fit(...) / admission_rows(...) -- page geometry (paged only)
#   prefill(ctx, extras, slot, pages) / decode(...) / decode_fused(...) /
#   release_slot(slot)


def _bucket_prompt(ctx: np.ndarray, ecfg: EngineConfig, pages: list[int],
                   first_page: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad a prompt to its prefill bucket and build the page-scatter ids:
    prompt page ``first_page + i`` maps to ``pages[i]``, every other
    bucket page (before the window, pad) to the trash page."""
    plen = len(ctx)
    bucket = -(-plen // ecfg.prefill_bucket) * ecfg.prefill_bucket
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = ctx
    pids = np.full((bucket // ecfg.page_size,), TRASH_PAGE, np.int32)
    pids[first_page:first_page + len(pages)] = pages
    return toks, pids


def _routed_prefill(backend, req: Request, ctx, slot: int, pages
                    ) -> np.ndarray:
    """Prefill dispatch that records/replays MoE routing: a routed
    backend's first prefill of a request stores the realized expert-drop
    mask on the request, and every re-prefill after preemption replays
    it, so a request's tokens are the same with or without preemption."""
    if not backend.routed:
        return backend.prefill(ctx, req.extras, slot, pages)
    logits = backend.prefill(ctx, req.extras, slot, pages,
                             replay=req.route_trace)
    if req.route_trace is None:
        req.route_trace = backend.last_route_trace
    return logits


class _Backend:
    """What every backend shares: the device, the per-step decode from
    host arrays and the fused horizon. A subclass gives ``decode_step``
    (one step on device tensors, updating ``self.state`` in place) and
    ``decode_eager`` (a horizon as the eager loop)."""

    page_bytes = 0
    slot_state_bytes = 0               # no per-slot non-paged state
    ring_rows = None                   # linear table growth (or no pages)
    routed = False                     # records/replays MoE drop masks
    prefix_sharing = False             # maps shared prompt pages

    def __init__(self, cfg, params, ecfg: EngineConfig):
        if L.dp_group_count() > 1:
            raise NotImplementedError(
                "the engine under a data axis of more than one rank: its "
                "slots are one replica's; data-parallel serving comes with "
                "a later slice of the mesh port (ROADMAP, Queue 1, item "
                "2.3)")
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.device = params["embed"].device
        self.graph: DecodeGraph | None = None   # the card's fused horizon

    @classmethod
    def supports(cls, cfg) -> bool:
        return True

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def release_slot(self, slot: int) -> None:
        """Nothing to free: pages go back through the allocator, and a
        recurrent slot's state is overwritten at its next admission."""

    # -- decode
    def decode(self, tokens, page_table, lengths, active) -> np.ndarray:
        """One decode step from host arrays; logits come back to the host."""
        def dev(a):
            return torch.as_tensor(a, device=self.device)
        return _host(self.decode_step(dev(tokens), dev(page_table),
                                      dev(lengths), dev(active)))

    def decode_fused(self, pending, lengths, remaining, page_table, mask,
                     h: int, teacher=None):
        """Advance the engine's persistent loop tensors (DeviceLoopState)
        by up to ``h`` decode steps in one call, greedy sampling on the
        device; returns the (hmax, B) token buffer. ``teacher`` (hmax, B)
        forces the sampled tokens (fused replay of a recorded sequence).
        On the card the horizon is CUDA-graph replays of the step
        (``self.graph``, captured at the first call's shape); on the CPU
        the eager loop (``decode_eager``)."""
        mask = torch.as_tensor(mask, device=self.device)
        if teacher is not None:
            teacher = torch.as_tensor(teacher, dtype=torch.int32,
                                      device=self.device)
        if self.device.type != "cuda":
            return self.decode_eager(pending, lengths, remaining, page_table,
                                     mask, h, teacher)
        if self.graph is None:
            B, M = page_table.shape
            self.graph = DecodeGraph(self.decode_step, B, M,
                                     self.ecfg.horizon, self.device)
        return self.graph.run(pending, lengths, remaining, page_table, mask,
                              h, teacher)


class _PagedBackend(_Backend):
    """What the paged backends share: the linear page geometry (the
    hybrid ring overrides it) and the decode dispatch into ``self.model``
    (a module with ``paged_decode_step`` and ``paged_decode_multi``).
    Every call updates the pool in place (the reference donates it)."""

    paged = True
    model = None

    # -- geometry: the page table grows with the context
    def can_ever_fit(self, pgr, prompt_len: int, max_new_tokens: int,
                     ctx_len: int) -> bool:
        return pgr.can_ever_fit(prompt_len, max_new_tokens, ctx_len,
                                pgr.num_pages)

    def admission_rows(self, pgr, ctx_len: int) -> list[int]:
        return list(range(pgr.pages_for(ctx_len)))

    # -- decode
    def decode_step(self, tokens, page_table, lengths, active):
        """One paged decode step on device tensors; returns logits (B, V)."""
        return self.model.paged_decode_step(self.cfg, self.params,
                                            self.state, tokens, page_table,
                                            lengths, active)

    def decode_eager(self, pending, lengths, remaining, page_table, mask,
                     h: int, teacher=None):
        """``decode_fused``'s horizon as the eager loop of the model's
        ``paged_decode_multi`` (every kernel enqueued from the host), on
        device tensors."""
        return self.model.paged_decode_multi(
            self.cfg, self.params, self.state, pending, lengths, remaining,
            page_table, mask, h, hmax=self.ecfg.horizon, teacher=teacher)


class PagedTransformerBackend(_PagedBackend):
    """Dense and vlm families: a paged KV cache read by the paged-decode
    kernel, prompts prefilled through the flash kernel (a vlm request's
    patch embeddings ride along as extras), prefix sharing with
    copy-on-write for the dense family only.

    Under a mesh (tensor parallel) every rank runs the
    engine's same host schedule: its pools hold its own cache heads (the
    KV heads expanded by ``layers.serve_kv_expand`` and split over the
    model axis), ``page_bytes`` counts those, and the model's paged
    functions return the whole vocabulary's logits, so every rank
    samples the same token."""

    model = T

    def __init__(self, cfg, params, ecfg: EngineConfig):
        super().__init__(cfg, params, ecfg)
        self.kv_expand = L.serve_kv_expand(cfg, L.tp_size())
        self.state = T.init_paged_decode_state(
            cfg, ecfg.num_pages, ecfg.page_size, device=self.device,
            kv_expand=self.kv_expand)
        self.page_bytes = ecfg.pager.page_bytes(cfg) \
            * self.state.k_pages.shape[1] // cfg.num_kv_heads
        # vlm stays out: M-RoPE position triples and per-request patch
        # embeds make "same token ids" insufficient for "same KV"
        self.prefix_sharing = cfg.family == "dense"

    # -- prefill
    def prefill(self, ctx: np.ndarray, extras, slot: int,
                page_ids: list[int]) -> np.ndarray:
        """Prefill one request (padded to its bucket), scatter its KV into
        ``page_ids``, return the last live token's logits (V,). The
        request's ``extras`` (vlm patches) join the batch with a leading
        axis of 1."""
        toks, pids = _bucket_prompt(ctx, self.ecfg, page_ids)
        batch = {"tokens": self._tensor(toks),
                 **{k: torch.as_tensor(v[None], device=self.device)
                    for k, v in (extras or {}).items()}}
        last, (k, v) = T.paged_prefill(self.cfg, self.params, batch,
                                       self._tensor([len(ctx)]),
                                       kv_expand=self.kv_expand)
        T.write_prefill_pages(self.cfg, self.state, (k[:, 0], v[:, 0]),
                              self._tensor(pids))
        return _host(last[0])

    def prefill_shared(self, ctx: np.ndarray, extras, slot: int,
                       page_ids: list[int], prefix_pages: list[int],
                       prefix_tokens: int) -> np.ndarray:
        """Prefill only the suffix past ``prefix_tokens`` (a page
        multiple) whose KV already sits in ``prefix_pages``; scatter the
        suffix KV into ``page_ids``, return last-live-token logits. The
        prefix-page operand is padded to the table width, as in the
        reference. Dense only: ``extras`` is unused."""
        suffix = ctx[prefix_tokens:]
        toks, pids = _bucket_prompt(suffix, self.ecfg, page_ids)
        pref = np.full((1, self.ecfg.max_pages_per_seq), TRASH_PAGE,
                       np.int32)
        pref[0, :len(prefix_pages)] = prefix_pages
        last, (k, v) = T.paged_prefill_shared(
            self.cfg, self.params, self.state,
            {"tokens": self._tensor(toks)}, self._tensor([len(suffix)]),
            self._tensor(pref), self._tensor([prefix_tokens]))
        T.write_prefill_pages(self.cfg, self.state, (k[:, 0], v[:, 0]),
                              self._tensor(pids))
        return _host(last[0])

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` into ``dst``."""
        T.copy_kv_page(self.state, src, dst)


class LatentBackend(_PagedBackend):
    """MLA-MoE (deepseek): pages hold compressed latent rows.

    A token's cache entry is its absorbed-MLA latent row (kv_lora_rank +
    rope head), not per-head K/V, so ``page_bytes`` is latent-width. The
    table grows linearly as in the dense backend. Prompts prefill at the
    exact-length expert capacity, and the realized drop masks are kept
    (``last_route_trace``) for replay after preemption.

    Under a mesh (tensor parallel, data axes of one rank) every rank runs
    the same host schedule: its pages hold its channels of the latent
    row (``moe.cache_width``), which ``page_bytes`` counts, every rank
    routes the same tokens to its own experts, so the recorded routes are
    one rank's, and the model's paged functions return the whole
    vocabulary's logits."""

    model = MoE
    routed = True

    @classmethod
    def supports(cls, cfg) -> bool:
        return cfg.mla is not None      # GQA-MoE (olmoe) has no backend

    def __init__(self, cfg, params, ecfg: EngineConfig):
        assert cfg.mla is not None, \
            "LatentBackend pages the MLA latent cache"
        super().__init__(cfg, params, ecfg)
        self.state = MoE.init_paged_decode_state(
            cfg, ecfg.num_pages, ecfg.page_size, device=self.device)
        self.page_bytes = (cfg.num_layers * ecfg.page_size
                           * self.state.kv_pages.shape[-1] * 2)
        self.last_route_trace: dict | None = None

    def prefill(self, ctx: np.ndarray, extras, slot: int,
                page_ids: list[int], replay: dict | None = None
                ) -> np.ndarray:
        """Prefill one request, scatter its latents into ``page_ids``,
        return the last live token's logits (V,). ``extras`` is unused.

        ``replay`` is the route trace of this request's first prefill
        ({"keep": (L, plen0, k) bool, "capacity": int}): its prompt keeps
        are forced, tokens generated since are forced kept (decode is
        dropless, so the first run kept them all) and pads forced dropped,
        so the re-prefill routes every token as the first run did. The
        replay ceiling is the first capacity plus the new tokens (each
        token claims an expert at most once), rounded up to a multiple of
        8 as in the reference; the extra slots are never filled."""
        toks, pids = _bucket_prompt(ctx, self.ecfg, page_ids)
        plen, bucket = len(ctx), toks.shape[1]
        if replay is None:
            cap = L.moe_dims(self.cfg, plen).capacity
            keep_arg = None
        else:
            keep0 = np.asarray(replay["keep"], bool)   # (L, plen0, k)
            Lc, plen0, k = keep0.shape
            forced = np.zeros((Lc, 1, bucket, k), bool)
            forced[:, 0, :plen0] = keep0
            forced[:, 0, plen0:plen] = True
            cap = -(-(int(replay["capacity"]) + plen - plen0) // 8) * 8
            keep_arg = self._tensor(forced, torch.bool)
        last, latents, keeps = MoE.paged_prefill(
            self.cfg, self.params, {"tokens": self._tensor(toks)},
            self._tensor([plen]), route_capacity=cap, route_keep=keep_arg)
        MoE.write_prefill_pages(self.cfg, self.state, latents[:, 0],
                                self._tensor(pids))
        if replay is None:
            self.last_route_trace = {"keep": _host(keeps[:, 0])[:, :plen],
                                     "capacity": cap}
        else:
            self.last_route_trace = replay
        return _host(last[0])


class RecurrentBackend(_Backend):
    """ssm family (rwkv6): a constant-size state per slot, no pages.

    The recurrence consumes every token it sees, so prompts prefill at
    their exact length (no bucket). A B = 1 prefill's state is written
    into its slot of the batch state in place. A released slot keeps its
    state: masked slots consume token 0 every step, as in the reference,
    and the next admission overwrites it. The fused horizon is the same
    ``DecodeGraph`` over a dummy (B, 1) page table, the reference's; its
    step updates the state's tensors in place, whose addresses the graph
    holds. Under a mesh (tensor parallel) every rank runs the same host
    schedule on its part of each slot's state (its heads' WKV matrices,
    its D slice of the registers), which ``slot_state_bytes`` counts, and
    samples from the whole vocabulary's logits."""

    paged = False

    def __init__(self, cfg, params, ecfg: EngineConfig):
        super().__init__(cfg, params, ecfg)
        self.state = R.init_decode_state(cfg, ecfg.num_slots,
                                         device=self.device)
        # the whole cache is per-slot constant state
        self.slot_state_bytes = _state_bytes(self.state)
        self._no_pages = torch.zeros((ecfg.num_slots, 1), dtype=torch.int32,
                                     device=self.device)

    def prefill(self, ctx: np.ndarray, extras, slot: int,
                page_ids=None) -> np.ndarray:
        """Prefill one request at its exact length into slot ``slot``;
        return the last token's logits (V,)."""
        logits, single = R.prefill(self.cfg, self.params,
                                   {"tokens": self._tensor(ctx[None])})
        for name in ("att_prev", "ffn_prev", "wkv"):
            getattr(self.state, name)[:, slot].copy_(
                getattr(single, name)[:, 0])
        return _host(L.whole_vocab(logits[0], self.cfg.vocab_size))

    def decode_step(self, tokens, page_table, lengths, active):
        """One step of every slot (inactive ones feed token 0); returns
        logits (B, V), the whole vocabulary's."""
        return L.whole_vocab(
            R.decode_step(self.cfg, self.params, self.state, tokens)[0],
            self.cfg.vocab_size)

    def decode_fused(self, pending, lengths, remaining, page_table, mask,
                     h: int, teacher=None):
        return super().decode_fused(pending, lengths, remaining,
                                    self._no_pages, mask, h, teacher)

    def decode_eager(self, pending, lengths, remaining, page_table, mask,
                     h: int, teacher=None):
        """A horizon as ``rwkv6.decode_multi``'s eager loop."""
        return R.decode_multi(self.cfg, self.params, self.state, pending,
                              lengths, remaining, mask, h,
                              hmax=self.ecfg.horizon, teacher=teacher)


class HybridBackend(_PagedBackend):
    """hybrid family (recurrentgemma, griffin): a constant-size recurrent
    state per slot plus a bounded sliding-window KV cache paged as a ring.

    The window ring holds ``ring_rows = ceil(window / page) + 1`` pages a
    slot; at every page boundary the engine frees the page that slid out
    of the attention window and maps a fresh one into the same table row
    (``_growth_row``), so cache bytes stay O(window) a slot however long
    the request runs, and a prompt of any length admits with the same
    bounded page count (only its last window of KV is paged). Inactive
    slots freeze their recurrent state; the fused horizon clamps at page
    boundaries, which are the ring's wrap points, so the table is constant
    inside a graph replay. Under a mesh (tensor parallel) every rank runs
    the same host schedule: its pools hold its cache heads (the KV head
    expanded by ``layers.serve_kv_expand`` and split over the model
    axis), its recurrent state its channels, and the model's paged
    functions return the whole vocabulary's logits."""

    model = G

    @classmethod
    def supports(cls, cfg) -> bool:
        return cfg.recurrent is not None

    def __init__(self, cfg, params, ecfg: EngineConfig):
        super().__init__(cfg, params, ecfg)
        self.window = cfg.recurrent.window
        self.ring_rows = G.ring_rows(self.window, ecfg.page_size)
        if (self.ring_rows > ecfg.max_pages_per_seq
                or self.ring_rows > ecfg.num_pages - 1):
            # statically infeasible geometry: raise here rather than
            # fail-fast every request as truncated at admission
            raise ValueError(
                f"{cfg.name}: window {self.window} needs a ring of "
                f"{self.ring_rows} pages (page_size {ecfg.page_size}), "
                f"but max_pages_per_seq={ecfg.max_pages_per_seq} and "
                f"the pool holds {ecfg.num_pages - 1} usable pages")
        _, n_attn = G._state_counts(cfg)
        self.kv_expand = L.serve_kv_expand(cfg, L.tp_size())
        self.state = G.init_paged_decode_state(
            cfg, ecfg.num_slots, ecfg.num_pages, ecfg.page_size,
            device=self.device, kv_expand=self.kv_expand)
        self.page_bytes = (2 * n_attn * ecfg.page_size
                           * self.state.k_pages.shape[1] * cfg.head_dim * 2)
        # constant per-slot recurrence bytes, reported beside the paged
        # window, as the static path's state holds the same conv/h arrays
        self.slot_state_bytes = _state_bytes((self.state.conv, self.state.h))

    # -- geometry: the window ring
    def can_ever_fit(self, pgr, prompt_len: int, max_new_tokens: int,
                     ctx_len: int) -> bool:
        """Window-bounded: the ring fitting the table row and the pool;
        prompt or generation length never disqualifies."""
        return (self.ring_rows <= pgr.max_pages_per_seq
                and self.ring_rows <= pgr.num_pages - 1)

    def admission_rows(self, pgr, ctx_len: int) -> list[int]:
        """Ring rows of the pages covering the live window: page n lands
        in row n % R; pages before the window are never allocated."""
        p, R = pgr.page_size, self.ring_rows
        n_lo = max(0, ctx_len - self.window) // p
        n_hi = (ctx_len - 1) // p
        return [n % R for n in range(n_lo, n_hi + 1)]

    # -- prefill
    def prefill(self, ctx: np.ndarray, extras, slot: int,
                page_ids: list[int]) -> np.ndarray:
        """Prefill one request (padded to its bucket, the recurrence gated
        at its length), scatter its in-window KV into ``page_ids`` (prompt
        pages from the window's first, ``n_lo``, on; the pages before it
        and the pad go to the trash page) and its recurrent state into slot
        ``slot``; return the last live token's logits (V,)."""
        n_lo = max(0, len(ctx) - self.window) // self.ecfg.page_size
        toks, pids = _bucket_prompt(ctx, self.ecfg, page_ids,
                                    first_page=n_lo)
        last, (k, v), conv, h = G.paged_prefill(
            self.cfg, self.params, {"tokens": self._tensor(toks)},
            self._tensor([len(ctx)]), kv_expand=self.kv_expand)
        G.write_prefill_state(self.cfg, self.state, (k[:, 0], v[:, 0]),
                              conv, h, self._tensor(pids), slot)
        return _host(last[0])


ENGINE_FAMILIES = {"dense": PagedTransformerBackend,
                   "vlm": PagedTransformerBackend,
                   "ssm": RecurrentBackend,
                   "hybrid": HybridBackend,
                   "moe": LatentBackend}


def engine_backend(cfg):
    """Backend class able to serve ``cfg``, or None."""
    cls = ENGINE_FAMILIES.get(cfg.family)
    if cls is None or not cls.supports(cfg):
        return None
    return cls


def resolve_backend(cfg):
    """engine_backend or raise, with the supported list taken from the
    registry."""
    cls = engine_backend(cfg)
    if cls is None:
        detail = ""
        if cfg.family in ENGINE_FAMILIES:
            detail = (f" ({ENGINE_FAMILIES[cfg.family].__name__} does not"
                      f" support this config)")
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}) has no engine backend"
            f"{detail}; families with backends: "
            f"{sorted(ENGINE_FAMILIES)}")
    return cls


# --- prefix sharing -------------------------------------------------------------


class _PrefixSharing:
    """The radix index plus the admission plan (which leading pages to
    map by reference instead of recomputing)."""

    def __init__(self, pgr: PagerConfig):
        self.pgr = pgr
        self.index = PrefixIndex(pgr.page_size)

    def plan(self, req: Request, ctx) -> tuple[list[int], int]:
        """-> (pages, tokens): the leading ``tokens`` of ``ctx`` are
        already resident in ``pages`` and need no prefill.

        A FRESH request always recomputes the page holding its last
        prompt token (the prefill must produce that token's logits), so
        coverage caps at the last page boundary strictly below len(ctx).
        A RE-ADMITTED request needs no logits, so full coverage is
        admissible, including a partial-tail match; a later decode write
        into that shared tail page copies-on-write first."""
        P = self.pgr.page_size
        tokens = [int(t) for t in ctx]
        pages, covered = self.index.match(
            tokens, allow_tail=bool(req.generated))
        if not req.generated:
            n = min(len(pages), (len(tokens) - 1) // P)
            pages, covered = pages[:n], n * P
        return pages, covered

    def record(self, alloc, ctx, lengths: int, row) -> int:
        """Index the full pages of a request's written context so later
        prompts can map them (after prefill, and again at preempt/finish)."""
        n_full = int(lengths) // self.pgr.page_size
        if n_full <= 0:
            return 0
        toks = [int(t) for t in ctx[:n_full * self.pgr.page_size]]
        return self.index.insert(alloc, toks,
                                 [int(p) for p in row[:n_full]])


# --- engine --------------------------------------------------------------------


class Engine:
    """Host-driven continuous-batching loop around a backend (paged, or
    the recurrent one's per-slot state)."""

    def __init__(self, cfg, params, ecfg: EngineConfig | None = None):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.backend = resolve_backend(cfg)(cfg, params, self.ecfg)
        self.rng = np.random.default_rng(self.ecfg.seed)
        self._sample_batch = make_batch_sampler(
            self.rng, self.ecfg.greedy, self.ecfg.temperature)
        # greedy sampling is pure argmax, so it can run on the device
        # inside the fused horizon; the host RNG's temperature draw cannot
        self._fused = self.ecfg.greedy and self.ecfg.horizon > 1
        self._dispatched: set = set()  # dispatch kinds already warmed up

    def run(self, requests: list[Request]) -> EngineReport:
        e, pgr = self.ecfg, self.ecfg.pager
        B, M, page = e.num_slots, pgr.max_pages_per_seq, pgr.page_size
        paged = self.backend.paged
        sched = Scheduler(requests)
        # one allocator over the whole pool: the reference's single-tenant
        # arena lease (all num_pages - 1 usable pages); none unpaged
        alloc = PageAllocator(e.num_pages) if paged else None
        sharer = _PrefixSharing(pgr) if (
            paged and e.prefix_sharing and self.backend.prefix_sharing) \
            else None

        slots: list[Request | None] = [None] * B
        page_table = np.zeros((B, M), np.int32)
        lengths = np.zeros((B,), np.int32)
        pending = np.zeros((B,), np.int32)      # next decode input token
        remaining = np.zeros((B,), np.int32)    # token budget left
        ds = DeviceLoopState(B, M, self.backend.device)

        rep = EngineReport(
            name=f"engine/{self.cfg.name}", num_slots=B,
            page_bytes=self.backend.page_bytes,
            slot_state_bytes=self.backend.slot_state_bytes,
            cache_bytes_alloc=_state_bytes(self.backend.state))
        t_run = time.monotonic()
        step = 0

        def clear_slot(s: int) -> None:
            req = slots[s]
            if sharer is not None:
                # index the pages this request completed BEFORE dropping
                # its refs: the neutral refs keep the prefix warm
                sharer.record(alloc, req.context_tokens, lengths[s],
                              page_table[s])
            slots[s] = None
            page_table[s, :] = TRASH_PAGE
            lengths[s] = 0
            pending[s] = 0
            remaining[s] = 0
            ds.touch(s)
            if paged:
                alloc.free_owner(req.rid)
            self.backend.release_slot(s)

        def finish(s: int) -> None:
            slots[s].done_step = step
            rep.completed.append(slots[s])
            clear_slot(s)

        def preempt(s: int) -> None:
            req = slots[s]
            clear_slot(s)
            sched.requeue(req)

        while True:
            sched.release_arrivals(step)

            # -- admission into free slots -------------------------------
            admitting = True
            for s in range(B):
                # retry the same slot until it is filled (rejected or
                # finished-at-prefill requests must not waste the slot)
                while admitting and slots[s] is None:
                    req = sched.peek_ready()
                    if req is None:
                        admitting = False
                        break
                    ctx = req.context_tokens
                    assert len(ctx) >= 1, "empty prompts are not admissible"
                    if paged:
                        rows = self.backend.admission_rows(pgr, len(ctx))
                        if not self.backend.can_ever_fit(
                                pgr, len(req.prompt), req.max_new_tokens,
                                len(ctx)):
                            sched.pop_ready()   # can never fit: fail fast
                            req.truncated = True
                            req.done_step = step
                            rep.completed.append(req)
                            continue
                        sh_pages, sh_tokens = (
                            sharer.plan(req, ctx) if sharer is not None
                            else ([], 0))
                        need = len(rows) - len(sh_pages)
                        if not alloc.can_alloc(need) and sharer is not None:
                            # index-only pages are cache: reclaim them
                            # before making the request wait
                            sharer.index.evict_lru(
                                alloc, need - alloc.free_count,
                                protect=set(sh_pages))
                        if not alloc.can_alloc(need):
                            admitting = False   # FCFS: wait for free pages
                            break
                        sched.pop_ready()
                        if sh_pages:
                            alloc.share(req.rid, sh_pages)
                            req.shared_pages += len(sh_pages)
                            rep.shared_page_hits += len(sh_pages)
                        pages = alloc.alloc(req.rid, need)
                        page_table[s, :] = TRASH_PAGE
                        page_table[s, rows] = sh_pages + pages
                        t0 = time.monotonic()
                        if sh_tokens >= len(ctx):
                            logits = None       # fully cached re-admission
                        elif sh_tokens:
                            logits = self.backend.prefill_shared(
                                ctx, req.extras, s, pages, sh_pages,
                                sh_tokens)
                        else:
                            logits = _routed_prefill(self.backend, req,
                                                     ctx, s, pages)
                        rep.prefill_wall_s += time.monotonic() - t0
                        full = (-(-len(ctx) // e.prefill_bucket)
                                * e.prefill_bucket)
                        computed = 0 if sh_tokens >= len(ctx) else (
                            -(-(len(ctx) - sh_tokens) // e.prefill_bucket)
                            * e.prefill_bucket)
                        rep.prefill_tokens += computed
                        rep.prefill_tokens_saved += full - computed
                        if computed:
                            rep.prefill_calls += 1
                            req.prefills += 1
                        if sharer is not None:
                            sharer.record(alloc, ctx, len(ctx),
                                          page_table[s])
                    else:
                        sched.pop_ready()
                        t0 = time.monotonic()
                        logits = _routed_prefill(self.backend, req, ctx, s,
                                                 None)
                        rep.prefill_wall_s += time.monotonic() - t0
                        rep.prefill_calls += 1
                        rep.prefill_tokens += len(ctx)   # exact length
                        req.prefills += 1
                    req.admitted_step = step
                    slots[s] = req
                    lengths[s] = len(ctx)
                    if req.generated:   # re-admission after preemption
                        pending[s] = req.generated[-1]
                        remaining[s] = (req.max_new_tokens
                                        - len(req.generated))
                        ds.touch(s)
                    else:
                        assert logits is not None
                        tok = int(self._sample_batch(logits[None])[0])
                        req.generated.append(tok)
                        pending[s] = tok
                        remaining[s] = req.max_new_tokens - 1
                        ds.touch(s)
                        if req.done:
                            finish(s)   # slot freed: while re-admits

            active = [s for s in range(B) if slots[s] is not None]

            # -- page growth / CoW / preemption --------------------------
            if paged and active:
                R = self.backend.ring_rows

                def claim_one(s: int) -> bool:
                    """Free one page for slot ``s``: index cache first,
                    then victim preemption. False if ``s`` itself was
                    preempted."""
                    while not alloc.can_alloc(1):
                        if sharer is not None \
                                and sharer.index.evict_lru(alloc, 1):
                            continue
                        victim = Scheduler.pick_victim(
                            [(v, slots[v]) for v in active
                             if slots[v] is not None], exclude=s)
                        if victim is None or victim[0] == s:
                            preempt(s)
                            active.remove(s)
                            return False
                        preempt(victim[0])
                        active.remove(victim[0])
                    return True

                for s in list(active):
                    if slots[s] is None:
                        continue
                    if lengths[s] % page != 0:
                        # mid-page: if the tail page is still shared (a
                        # re-admission mapped a cached tail), copy-on-
                        # write exactly that page before the next append
                        if sharer is None:
                            continue
                        row_i = lengths[s] // page
                        old = int(page_table[s, row_i])
                        if alloc.refcount(old) < 2:
                            continue
                        if not claim_one(s):
                            continue
                        new = alloc.alloc(slots[s].rid, 1)
                        self.backend.copy_page(old, new[0])
                        alloc.free_page(slots[s].rid, old)
                        page_table[s, row_i] = new[0]
                        ds.touch(s)
                        slots[s].cow_copies += 1
                        rep.cow_copies += 1
                        continue
                    pi = lengths[s] // page
                    if R is None and pi >= M:   # table row full: stop
                        slots[s].truncated = True
                        finish(s)
                        active.remove(s)
                        continue
                    row = _growth_row(self.backend, alloc, page_table, s,
                                      pi, slots[s].rid)
                    if not claim_one(s):
                        continue
                    new = alloc.alloc(slots[s].rid, 1)
                    page_table[s, row] = new[0]
                    ds.touch(s)

            # -- decode: one fused horizon, or one per-step dispatch -----
            if active:
                act = np.zeros((B,), bool)
                act[active] = True
                if self._fused:
                    # safe horizon: no schedulable event may land inside
                    # it, so h device steps equal h iterations of this loop
                    h = e.horizon
                    nxt = sched.next_arrival()
                    if nxt is not None:
                        h = min(h, nxt - step)     # arrival -> admission
                    if sched.peek_ready() is not None and \
                            any(slots[s] is None for s in range(B)):
                        h = 1   # a free slot retries admission per step
                    for s in active:
                        h = min(h, int(remaining[s]))  # finish at budget
                        if paged:                      # page growth
                            h = min(h, pgr.steps_to_boundary(
                                int(lengths[s])))
                    h = max(1, h)
                    ds.sync(page_table, lengths, pending, remaining)
                    t0 = time.monotonic()
                    out = self.backend.decode_fused(
                        ds.pending, ds.lengths, ds.remaining, ds.table,
                        act, h)
                    toks_h = _host(out)    # ONE host sync per horizon
                    _charge_wall(rep, self._dispatched, "fused",
                                 time.monotonic() - t0)
                    ds.count(dispatches=1, syncs=1)
                    rep.decode_steps += h
                    rep.slot_steps += B * h
                    rep.useful_slot_steps += len(active) * h
                    step += h - 1   # bookkeeping lands at horizon end
                    lengths[active] += h
                    remaining[active] -= h
                    for s in active:
                        req = slots[s]
                        req.generated.extend(int(t) for t in toks_h[:h, s])
                        pending[s] = int(toks_h[h - 1, s])
                        if req.done:
                            finish(s)
                else:
                    t0 = time.monotonic()
                    logits = self.backend.decode(pending, page_table,
                                                 lengths, act)
                    _charge_wall(rep, self._dispatched, "decode",
                                 time.monotonic() - t0)
                    ds.count(dispatches=1, syncs=1,
                             upload_bytes=page_table.nbytes)
                    rep.decode_steps += 1
                    rep.slot_steps += B    # the batch always runs full
                    rep.useful_slot_steps += len(active)
                    lengths[active] += 1
                    remaining[active] -= 1
                    toks = self._sample_batch(logits[active])
                    for i, s in enumerate(active):
                        req = slots[s]
                        tok = int(toks[i])
                        req.generated.append(tok)
                        pending[s] = tok
                        if req.done:
                            finish(s)
                if paged:
                    rep.peak_live_pages = max(rep.peak_live_pages,
                                              alloc.live_count)
                    rep.peak_demand_pages = max(rep.peak_demand_pages,
                                                alloc.demand_count)
            elif not sched.exhausted:
                nxt = sched.next_arrival()
                if nxt is not None and nxt > step:
                    step = nxt          # idle: fast-forward to next arrival
                    continue
            else:
                break

            step += 1
            if step > e.max_steps:
                raise RuntimeError("engine exceeded max_steps")

        if paged:
            if sharer is not None:      # drop the index's neutral refs
                sharer.index.release_all(alloc)
            alloc.check()
            assert alloc.live_count == 0, "pages leaked past completion"
        rep.preemptions = sched.preemptions
        rep.device_dispatches = ds.device_dispatches
        rep.host_syncs = ds.host_syncs
        rep.page_table_upload_bytes = ds.page_table_upload_bytes
        rep.wall_s = time.monotonic() - t_run
        return rep


def _growth_row(backend, alloc, page_table, s: int, pi: int, rid: int
                ) -> int:
    """Table row for a slot's next page. Linear backends grow into row
    ``pi``; ring backends wrap into ``pi % ring_rows``, and the page
    already in that row is freed first, which is safe exactly because the
    ring holds ceil(window / page) + 1 rows: the wrapped-out page's
    positions are all <= pos - window, outside the attention window."""
    R = backend.ring_rows
    if R is None:
        return pi
    row = pi % R
    old = int(page_table[s, row])
    if old != TRASH_PAGE:
        alloc.free_page(rid, old)
        page_table[s, row] = TRASH_PAGE
    return row


# --- multi-tenant pooled engine ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolEngineConfig(EngineConfig):
    """EngineConfig plus the multi-tenant activation policy.

    ``reload_aware`` (the paper-derived control loop): all hot models
    share the slot batch, cold models activate only when the slab has
    room or a hysteresis-expired idle victim exists, eviction is least
    value-per-byte first. ``round_robin`` is the naive baseline: one
    swappable model hot at a time, served in fixed cyclic quanta, with
    every switch evicting the previous occupant (and preempting its
    in-flight slots) regardless of reload cost.

    ``stream`` picks the reload granularity for reload_aware activations:
    ``model`` charges the whole reload as serial stall steps up front
    (the first design); ``layer`` streams the per-layer schedule behind
    compute (ModelPool.begin_stream — the paper's folded-tile pipelining
    at serving scale), charging a stall step only when the engine has no
    decode work to hide the DMA behind. round_robin is model-granular by
    definition (every switch drops the previous occupant whole).

    ``repartition`` controls the device-memory arena's KV page leases:
    ``off`` freezes the init-time demand-proportional partition (the static
    split); ``epoch`` samples per-tenant live-page watermarks every
    step and, every ``epoch_steps``, shrinks under-watermark tenants and
    grows page-starved ones (free pages only — see runtime.arena).

    ``max_bypass_steps`` is the global aging bound on the admission scan:
    a page-starved tenant's head request may be bypassed by neighbouring
    tenants' later arrivals for at most this many steps, after which the
    scan BLOCKS for it (no later-arrival admissions) until its pages free
    up. 0 disables the bound (unbounded bypass).
    """
    policy: str = "reload_aware"       # | "round_robin"
    rr_quantum: int = 16               # steps per round-robin turn
    stream: str = "model"              # | "layer"
    repartition: str = "off"           # | "epoch"
    epoch_steps: int = 64
    max_bypass_steps: int = 64         # 0 -> unbounded bypass

    def __post_init__(self):
        super().__post_init__()
        assert self.policy in ("reload_aware", "round_robin")
        assert self.rr_quantum >= 1
        assert self.stream in ("model", "layer")
        assert self.repartition in ("off", "epoch")
        assert self.epoch_steps >= 1
        assert self.max_bypass_steps >= 0


@dataclasses.dataclass
class PooledReport(EngineReport):
    """EngineReport plus weight-reload accounting. Reload stalls are
    serial with compute (§2.2), so they join the throughput denominator
    alongside prefill-equivalent steps: tokens/step counts stalled steps
    as steps that produced nothing."""
    policy: str = ""
    stream: str = ""
    stall_steps: int = 0
    reload_bytes: int = 0
    restream_bytes: int = 0            # bounded-slab re-fetch share
    reload_events: int = 0
    evictions: int = 0
    deferred_activations: int = 0
    repartitions: int = 0              # arena epochs executed
    pages_moved: int = 0               # leases moved between tenants
    aging_blocks: int = 0              # admission scans blocked by aging
    peak_live_page_bytes: int = 0      # tenants' page sizes differ
    peak_demand_page_bytes: int = 0    # live minus index-only, in bytes
    model_tokens: dict = dataclasses.field(default_factory=dict)
    stall_steps_by_model: dict = dataclasses.field(default_factory=dict)

    @property
    def kv_bytes_peak(self) -> int:
        """Peak live cache bytes summed per tenant at its OWN page size
        (an MLA latent page is far smaller than a dense KV page, so
        pages * max(page_bytes) would materially overstate the peak)."""
        if self.page_bytes:
            return self.peak_live_page_bytes + self.slot_state_bytes
        return self.cache_bytes_alloc

    @property
    def kv_demand_bytes_peak(self) -> int:
        """Peak referenced-by-some-request cache bytes per tenant page
        size (shared pages once, index-only cache excluded)."""
        if self.page_bytes:
            return self.peak_demand_page_bytes + self.slot_state_bytes
        return self.cache_bytes_alloc

    @property
    def decode_tokens_per_step(self) -> float:
        return self.new_tokens / max(self.decode_steps + self.stall_steps, 1)

    @property
    def tokens_per_step(self) -> float:
        return self.new_tokens / max(
            self.decode_steps + self.stall_steps + self.prefill_equiv_steps,
            1.0)

    def summary(self) -> dict:
        s = super().summary()
        s.update({
            "policy": self.policy,
            "stream": self.stream,
            "stall_steps": self.stall_steps,
            "stall_steps_by_model": dict(
                sorted(self.stall_steps_by_model.items())),
            "reload_bytes": self.reload_bytes,
            "restream_bytes": self.restream_bytes,
            "reload_events": self.reload_events,
            "evictions": self.evictions,
            "deferred_activations": self.deferred_activations,
            "repartitions": self.repartitions,
            "pages_moved": self.pages_moved,
            "aging_blocks": self.aging_blocks,
            "model_tokens": dict(sorted(self.model_tokens.items())),
        })
        return s


class PooledEngine:
    """Continuous batching for a model zoo sharing one accelerator pool.

    Per-model backends (each with its own KV pool and, on the card, its
    own CUDA graph of the decode step) split one modeled page budget: the page-id space is PARTITIONED into per-tenant
    proportional sub-ranges (partition_pages), each backed by its own
    device pool and host-side PageAllocator, so the physical backing
    matches the modeled shared budget instead of every tenant allocating
    the full pool. Page pressure is tenant-local (a burst on one tenant
    preempts its own requests, not its neighbours'), while one slot array
    spans all tenants, so batch width stays a shared resource.

    One engine step advances EVERY hot tenant's slots (stationary
    weights of all hot models sit in HBM at once — the packed-canvas
    premise at pool scale — so their decodes share the step the way
    packed layers share the fabric); the step still spans at most
    ``num_slots`` tokens, so tokens/step is bounded by the slot width
    for every policy. Weight reloads are serial with compute, charged
    as stall steps that produce nothing. The naive round-robin baseline
    keeps a single swappable tenant hot at a time, so it cannot use the
    shared step — that utilization gap, plus its per-switch reloads, is
    exactly what the reload-aware policy is measured against.
    """

    def __init__(self, pool: ModelPool, params: dict,
                 ecfg: PoolEngineConfig | None = None):
        if pool.plan is None:
            pool.pack()
        self.pool = pool
        self.ecfg = ecfg or PoolEngineConfig()
        assert pool.pcfg.slab_mode != "bounded" \
            or self.ecfg.stream == "layer", \
            "bounded slab mode re-streams through the layer-granular " \
            "DMA FIFO; run it with stream='layer'"
        paged_shares = {
            e.model_id: e.demand for e in pool.plan.entries
            if getattr(engine_backend(e.cfg), "paged", False)}
        # the arena owns the whole modeled budget: the KV page region
        # (per-tenant leases over one shared page budget) plus the weight
        # region (pin + slab) whose occupancy the pool reports back
        self.arena = DeviceArena(
            ArenaConfig(kv_pages=self.ecfg.num_pages,
                        pin_bytes=pool.pcfg.pin_budget_bytes,
                        slab_bytes=pool.pcfg.slab_bytes,
                        repartition=self.ecfg.repartition,
                        epoch_steps=self.ecfg.epoch_steps),
            paged_shares)
        self.page_split = self.arena.page_split
        self.backends = {}
        self._pgr = {}                 # per-tenant pager geometry
        for e in pool.plan.entries:
            backend_cls = resolve_backend(e.cfg)
            ecfg_t = self.ecfg
            if e.model_id in self.page_split:
                # tenant's device pool backs its provisioned rows (+ its
                # own trash page): with repartition off that is exactly
                # its lease, so physical bytes track the partition; in
                # epoch mode rows are provisioned up to the grow cap
                # while the MODELED leases stay conserved by the arena.
                # Admission FEASIBILITY however is judged against the
                # guaranteed INITIAL lease, not the cap — a grown lease
                # is opportunistic and can shrink back, so a request
                # must be completable under the static share alone.
                ecfg_t = dataclasses.replace(
                    self.ecfg,
                    num_pages=self.arena.cap(e.model_id) + 1)
                self._pgr[e.model_id] = dataclasses.replace(
                    self.ecfg,
                    num_pages=self.page_split[e.model_id] + 1).pager
            else:
                self._pgr[e.model_id] = ecfg_t.pager
            self.backends[e.model_id] = backend_cls(
                e.cfg, params[e.model_id], ecfg_t)
            if e.model_id in self.page_split:
                self.arena.register_page_bytes(
                    e.model_id, self.backends[e.model_id].page_bytes)
        if self.ecfg.repartition == "off":
            assert sum(n + 1 for n in self.page_split.values()) \
                <= self.ecfg.num_pages, \
                "physical pages exceed the pool budget"
        self.rng = np.random.default_rng(self.ecfg.seed)
        self._sample_batch = make_batch_sampler(
            self.rng, self.ecfg.greedy, self.ecfg.temperature)
        self._fused = self.ecfg.greedy and self.ecfg.horizon > 1
        self._dispatched: set = set()  # dispatch kinds already warmed up
        self.device = next(iter(self.backends.values())).device

    # -- main loop ---------------------------------------------------------
    # The loop is split into start / step_once / finish_run so a caller
    # can interleave OTHER work between engine steps: the fleet tier
    # drives N replicas in lockstep ticks, injecting requests and faults
    # mid-run. ``run`` composes the three for the single-pool case.

    def start(self, requests: list[Request]) -> "PooledEngine":
        e, pool = self.ecfg, self.pool
        self._sched = MultiQueueScheduler(requests)
        # the arena hands each paged tenant its leased allocator (a fresh
        # run starts from the initial demand-proportional partition)
        self.arena.reset_runtime()
        self._allocs = {m: self.arena.allocator(m) for m in self.page_split}
        # one prefix index per eligible tenant: page ids are tenant-local
        # and token-id equality only implies KV equality within a model
        self._sharers = {
            m: _PrefixSharing(self._pgr[m]) for m in self.page_split
            if e.prefix_sharing
            and getattr(self.backends[m], "prefix_sharing", False)}
        pool.reset_runtime()

        B = e.num_slots
        self._order = list(pool.model_ids)
        self._slots: list[Request | None] = [None] * B
        self._page_table = np.zeros((B, e.pager.max_pages_per_seq),
                                    np.int32)
        self._lengths = np.zeros((B,), np.int32)
        self._pending = np.zeros((B,), np.int32)
        self._remaining = np.zeros((B,), np.int32)
        # one device twin spans every tenant: the fused dispatches chain
        # through it (each tenant's horizon advances only its own slots'
        # rows in place, so model B's call reads what model A left)
        self._ds = DeviceLoopState(B, e.pager.max_pages_per_seq,
                                   self.device)
        self._rep = PooledReport(
            name=f"pool/{e.policy}", num_slots=B, policy=e.policy,
            stream=e.stream,
            page_bytes=max(
                (self.backends[m].page_bytes for m in self.page_split),
                default=0),
            slot_state_bytes=sum(b.slot_state_bytes
                                 for b in self.backends.values()),
            cache_bytes_alloc=sum(_state_bytes(b.state)
                                  for b in self.backends.values()),
            model_tokens={m: 0 for m in self._order},
            stall_steps_by_model={m: 0 for m in self._order})
        self._t_run = time.monotonic()
        self.step = 0
        self._rr_current: str | None = None
        self._rr_left = 0
        self._blocked_since: dict[int, int] = {}  # rid -> first blocked step
        return self

    # -- steppable-loop accessors (the fleet router reads these) -----------

    @property
    def report(self) -> PooledReport:
        return self._rep

    def inject(self, requests: list[Request]) -> None:
        """Hand this replica more requests mid-run (fleet dispatch)."""
        self._sched.inject(requests)

    def occupied_slots(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def backlog(self) -> int:
        """Requests queued but not in a slot (ready + future arrivals)."""
        sch = self._sched
        return (sum(sch.ready_count(m) for m in sch.ready_models())
                + len(sch._pending))

    def load(self) -> int:
        """Routing load signal: occupied slots + queued requests."""
        return self.occupied_slots() + self.backlog()

    def oldest_queued_age(self) -> int:
        """Steps the longest-waiting READY request has been queued.
        Load alone hides a stuck head (two replicas at equal load, one
        with a request aging behind a page-starved tenant), so the
        fleet router folds this in as a tiebreak."""
        arr = self._sched.oldest_ready_arrival()
        return max(0, self.step - arr) if arr is not None else 0

    def drain(self) -> list[Request]:
        """Failover: preempt every in-flight request and pull the whole
        queue out, returning ALL unfinished requests for re-admission on
        another replica (their generated tokens and MoE route traces ride
        along, so nothing restarts from scratch beyond the re-prefill)."""
        for s in range(len(self._slots)):
            if self._slots[s] is not None:
                self._preempt(s)
        return self._sched.drain()

    # -- slot lifecycle -----------------------------------------------------

    def _clear_slot(self, s: int) -> None:
        req = self._slots[s]
        sharer = self._sharers.get(req.model_id)
        if sharer is not None:
            # index the completed pages before the refs drop: the
            # neutral refs keep the prefix warm for later prompts
            sharer.record(self._allocs[req.model_id], req.context_tokens,
                          self._lengths[s], self._page_table[s])
        self._slots[s] = None
        self._page_table[s, :] = TRASH_PAGE
        self._lengths[s] = 0
        self._pending[s] = 0
        self._remaining[s] = 0
        self._ds.touch(s)
        if req.model_id in self._allocs:
            self._allocs[req.model_id].free_owner(req.rid)
        self.backends[req.model_id].release_slot(s)

    def _finish(self, s: int) -> None:
        self._slots[s].done_step = self.step
        self._rep.completed.append(self._slots[s])
        self._clear_slot(s)

    def _preempt(self, s: int) -> None:
        req = self._slots[s]
        self._clear_slot(s)
        self._sched.requeue(req)

    def _reject(self, req: Request) -> None:
        req.truncated = True
        req.done_step = self.step
        self._rep.completed.append(req)

    def _active_models(self) -> list[str]:
        got = {r.model_id for r in self._slots if r is not None}
        return [m for m in self._order if m in got]

    def _pick_admissible(self, serve: list[str]) -> Request | None:
        """Earliest ready head whose tenant can admit now. Page
        pressure is tenant-local (partitioned sub-ranges), so a
        page-starved tenant waits without blocking its neighbours —
        but only up to the aging bound: once a blocked head has been
        bypassed for ``max_bypass_steps``, the scan BLOCKS for it
        instead of admitting later arrivals past it. Heads that can
        never fit are failed fast along the way."""
        e, sched, step = self.ecfg, self._sched, self.step
        while True:
            for req in sched.ready_heads(serve):
                backend = self.backends[req.model_id]
                if not backend.paged:
                    return req
                pgr_t = self._pgr[req.model_id]
                ctx_len = len(req.context_tokens)
                if not backend.can_ever_fit(pgr_t, len(req.prompt),
                                            req.max_new_tokens,
                                            ctx_len):
                    self._blocked_since.pop(req.rid, None)
                    self._reject(sched.pop_ready(req))
                    break           # queues changed: rescan heads
                rows = backend.admission_rows(pgr_t, ctx_len)
                a = self._allocs[req.model_id]
                need = len(rows)
                sharer = self._sharers.get(req.model_id)
                if sharer is not None:
                    sh_pages, _ = sharer.plan(req, req.context_tokens)
                    need -= len(sh_pages)
                    if not a.can_alloc(need):
                        # reclaim index-only cache pages, protecting the
                        # ones the plan is about to map by reference
                        sharer.index.evict_lru(a, need - a.free_count,
                                               protect=set(sh_pages))
                if a.can_alloc(need):
                    self._blocked_since.pop(req.rid, None)
                    return req
                # page-blocked head: feed the arena's load signal and
                # age it — an over-aged head stops the scan so later
                # arrivals cannot bypass it indefinitely
                first = self._blocked_since.setdefault(req.rid, step)
                self.arena.note_starved(req.model_id, step, want=need)
                if e.max_bypass_steps \
                        and step - first >= e.max_bypass_steps:
                    self._rep.aging_blocks += 1
                    return None
            else:
                return None

    def step_once(self) -> bool:
        """Advance the pool one engine step. Returns False when nothing
        can progress — every queue is empty and no slot is occupied (the
        single-pool ``run`` stops there; the fleet keeps an idle replica
        alive because the router may inject work or faults later) — and
        True otherwise, including idle fast-forwards to a future
        arrival."""
        e, pool = self.ecfg, self.pool
        B, page = e.num_slots, e.pager.page_size
        M = e.pager.max_pages_per_seq
        sched, rep, allocs = self._sched, self._rep, self._allocs
        slots, page_table = self._slots, self._page_table
        lengths, pending = self._lengths, self._pending

        sched.release_arrivals(self.step)

        # -- drain queues no backend can ever serve ------------------
        for m in sched.ready_models():
            if m not in self.backends or not pool.servable(m):
                while (req := sched.peek_ready([m])) is not None:
                    self._reject(sched.pop_ready(req))

        # -- activation policy ---------------------------------------
        if e.policy == "round_robin":
            ready = sched.ready_models()
            rr = self._rr_current
            switch = (rr is None or self._rr_left <= 0
                      or (rr not in self._active_models()
                          and sched.ready_count(rr) == 0))
            if switch and ready:
                order = self._order
                start = ((order.index(rr) + 1) % len(order)
                         if rr is not None else 0)
                nxt = next((order[(start + i) % len(order)]
                            for i in range(len(order))
                            if order[(start + i) % len(order)] in ready),
                           None)
                if nxt is not None and nxt != rr:
                    # naive swap: drop everything, load the next model
                    for s in range(B):
                        if slots[s] is not None:
                            self._preempt(s)
                    for m in list(pool.hot_models()):
                        pool.evict(m)
                    stall, _ = pool.try_activate(nxt, self.step)
                    rep.stall_steps += stall
                    rep.stall_steps_by_model[nxt] += stall
                    self.step += stall
                    self._rr_current, self._rr_left = nxt, e.rr_quantum
                elif nxt is not None:
                    self._rr_left = e.rr_quantum
            serve = [self._rr_current] if self._rr_current is not None \
                else []
        else:
            cold = [m for m in sched.ready_models()
                    if not pool.is_hot(m)]
            if cold:
                # highest queued-demand per reload byte activates
                # first; if it must wait (hysteresis), a smaller cold
                # tenant that fits the free slab may still go
                cold.sort(key=lambda m: (
                    -sched.pending_demand(m)
                    / max(pool.plan.entry(m).reload_bytes, 1), m))
                protected = frozenset(
                    m for m in pool.hot_models()
                    if m in self._active_models()
                    or sched.ready_count(m) > 0)
                for m in cold:
                    if e.stream == "layer":
                        # layer-granular: reserve the slab, then let
                        # the per-layer schedule stream behind compute
                        # (stalls only surface as prefetch misses,
                        # charged after the decode section)
                        if pool.begin_stream(m, self.step, protected) \
                                is not None:
                            break   # the DMA issues one stream at once
                    else:
                        res = pool.try_activate(m, self.step, protected)
                        if res is not None:
                            stall, _ = res
                            rep.stall_steps += stall
                            rep.stall_steps_by_model[m] += stall
                            self.step += stall
                            break   # one reload/step: stalls serialize
            if e.stream == "layer":
                # a mid-stream model joins once it heads the serial
                # DMA queue and the un-streamed tail fits inside its
                # first decode step's own layer walk
                serve = [m for m in pool.hot_models()
                         if pool.decode_ready(m)]
            else:
                serve = pool.hot_models()

        # -- admission into free slots -------------------------------
        admitting = True
        for s in range(B):
            while admitting and slots[s] is None:
                req = self._pick_admissible(serve)
                if req is None:
                    admitting = False
                    break
                backend = self.backends[req.model_id]
                ctx = req.context_tokens
                assert len(ctx) >= 1, "empty prompts are not admissible"
                if backend.paged:
                    sched.pop_ready(req)
                    a = allocs[req.model_id]
                    rows = backend.admission_rows(
                        self._pgr[req.model_id], len(ctx))
                    sharer = self._sharers.get(req.model_id)
                    sh_pages, sh_tokens = (
                        sharer.plan(req, ctx) if sharer is not None
                        else ([], 0))
                    if sh_pages:
                        a.share(req.rid, sh_pages)
                        req.shared_pages += len(sh_pages)
                        rep.shared_page_hits += len(sh_pages)
                    pages = a.alloc(req.rid, len(rows) - len(sh_pages))
                    page_table[s, :] = TRASH_PAGE
                    page_table[s, rows] = sh_pages + pages
                    if sh_tokens >= len(ctx):
                        logits = None   # fully cached re-admission
                    elif sh_tokens:
                        logits = backend.prefill_shared(
                            ctx, req.extras, s, pages, sh_pages,
                            sh_tokens)
                    else:
                        logits = _routed_prefill(backend, req, ctx, s,
                                                 pages)
                    full = (-(-len(ctx) // e.prefill_bucket)
                            * e.prefill_bucket)
                    computed = 0 if sh_tokens >= len(ctx) else (
                        -(-(len(ctx) - sh_tokens) // e.prefill_bucket)
                        * e.prefill_bucket)
                    rep.prefill_tokens += computed
                    rep.prefill_tokens_saved += full - computed
                    if computed:
                        rep.prefill_calls += 1
                        req.prefills += 1
                    if sharer is not None:
                        sharer.record(a, ctx, len(ctx), page_table[s])
                else:
                    sched.pop_ready(req)
                    logits = _routed_prefill(backend, req, ctx, s,
                                             None)
                    rep.prefill_calls += 1
                    rep.prefill_tokens += len(ctx)
                    req.prefills += 1
                req.admitted_step = self.step
                slots[s] = req
                lengths[s] = len(ctx)
                if req.generated:   # re-admission after preemption
                    pending[s] = req.generated[-1]
                    self._remaining[s] = (req.max_new_tokens
                                          - len(req.generated))
                    self._ds.touch(s)
                else:
                    assert logits is not None
                    tok = int(self._sample_batch(logits[None])[0])
                    req.generated.append(tok)
                    pending[s] = tok
                    self._remaining[s] = req.max_new_tokens - 1
                    self._ds.touch(s)
                    rep.model_tokens[req.model_id] += 1
                    if req.done:
                        self._finish(s)

        # -- one fused decode step over every hot tenant's slots -----
        # Weights of all hot tenants sit in HBM simultaneously (the
        # packed-canvas premise at pool scale), so their slots advance
        # in the same engine step; the naive round-robin baseline only
        # ever holds one swappable tenant hot, so it cannot use this
        # concurrency — that utilization gap is the point.
        did_compute = False
        if self._active_models():
            # page growth / preemption for every paged tenant's slot
            for s in range(B):
                if slots[s] is None:
                    continue
                mid = slots[s].model_id
                if not self.backends[mid].paged:
                    continue
                if e.stream == "layer" and not pool.decode_ready(mid):
                    # no decode this step (mid-re-stream / queued
                    # behind the DMA): growing now would re-fire on
                    # every blocked step and orphan the previous
                    # page into the same table row
                    continue
                a = allocs[mid]
                sharer = self._sharers.get(mid)

                def claim_one(s: int, mid: str = mid, a=a,
                              sharer=sharer) -> bool:
                    """Free one page for slot ``s``: index cache first,
                    then same-tenant victim preemption (a victim's
                    pages may land in the index — evictable next
                    iteration, so the loop still strictly shrinks live
                    state). False if ``s`` itself was preempted."""
                    if not a.can_alloc(1):
                        # growth pressure is the other load signal the
                        # arena repartitions on (preempt == starvation)
                        self.arena.note_starved(mid, self.step)
                    while not a.can_alloc(1):
                        if sharer is not None \
                                and sharer.index.evict_lru(a, 1):
                            continue
                        # only same-tenant slots are useful victims —
                        # the page-id space is partitioned, so a
                        # neighbour's pages can never back this growth
                        tenant_active = [
                            (v, slots[v]) for v in range(B)
                            if slots[v] is not None
                            and slots[v].model_id == mid]
                        victim = Scheduler.pick_victim(tenant_active,
                                                       exclude=s)
                        if victim is None or victim[0] == s:
                            self._preempt(s)
                            return False
                        self._preempt(victim[0])
                    return True

                if lengths[s] % page != 0:
                    # mid-page: the next decode appends into the tail
                    # page — if it is still shared (re-admission mapped
                    # a cached tail), copy-on-write exactly that page
                    if sharer is None:
                        continue
                    row_i = lengths[s] // page
                    old = int(page_table[s, row_i])
                    if a.refcount(old) < 2:
                        continue
                    if not claim_one(s):
                        continue
                    new = a.alloc(slots[s].rid, 1)
                    self.backends[mid].copy_page(old, new[0])
                    a.free_page(slots[s].rid, old)
                    page_table[s, row_i] = new[0]
                    self._ds.touch(s)
                    slots[s].cow_copies += 1
                    rep.cow_copies += 1
                    continue
                pi = lengths[s] // page
                R = self.backends[mid].ring_rows
                if R is None and pi >= M:
                    slots[s].truncated = True
                    self._finish(s)
                    continue
                row = _growth_row(self.backends[mid], a, page_table,
                                  s, pi, slots[s].rid)
                if not claim_one(s):
                    continue
                new = a.alloc(slots[s].rid, 1)
                page_table[s, row] = new[0]
                self._ds.touch(s)

            # safe horizon: h > 1 only when no schedulable event —
            # arrival, admission retry, cold activation, rr switch,
            # stream/burst accounting, epoch boundary, page boundary,
            # slot finish — can land mid-horizon, so h fused steps are
            # step-for-step identical to h per-step iterations
            h = 1
            if self._fused:
                h = e.horizon
                if e.policy == "round_robin":
                    h = min(h, max(1, self._rr_left))
                if pool.pcfg.slab_mode == "bounded" or (
                        e.stream == "layer" and pool.streaming):
                    h = 1   # DMA ticks / decode bursts settle per step
                ready = sched.ready_models()
                if any(m not in serve for m in ready):
                    h = 1   # cold tenant retries activation every step
                if ready and any(r is None for r in slots):
                    h = 1   # free slot retries admission every step
                nxt = sched.next_arrival()
                if nxt is not None:
                    h = min(h, nxt - self.step)
                ne = self.arena.next_epoch_step()
                if ne is not None:      # boundary must land on a step
                    h = min(h, ne - self.step + 1)
                for s in range(B):
                    if slots[s] is None:
                        continue
                    h = min(h, int(self._remaining[s]))
                    if self.backends[slots[s].model_id].paged:
                        h = min(h, self._pgr[slots[s].model_id]
                                .steps_to_boundary(int(lengths[s])))
                h = max(1, h)
                self._ds.sync(page_table, lengths, pending,
                              self._remaining)
            # bookkeeping below (finish steps, arena epoch) sees the
            # horizon's last step, exactly as the per-step loop would
            self.step += h - 1
            self._rr_left -= h - 1

            served = 0
            for m in self._active_models():
                backend = self.backends[m]
                m_slots = [s for s in range(B)
                           if slots[s] is not None
                           and slots[s].model_id == m]
                if not m_slots:
                    continue
                if e.stream == "layer" and not pool.decode_ready(m):
                    # a bounded-slab tenant mid-re-stream (or a tenant
                    # queued behind the serial DMA) skips this step;
                    # its slots wait while the FIFO drains
                    continue
                act = np.zeros((B,), bool)
                act[m_slots] = True
                if self._fused:
                    # tenants chain through the shared device tensors:
                    # each fused call masks to its own slots (and blanks
                    # other tenants' table rows on device) and advances
                    # only its own slots' rows in place
                    ds = self._ds
                    t0 = time.monotonic()
                    out = backend.decode_fused(
                        ds.pending, ds.lengths, ds.remaining, ds.table,
                        act, h)
                    toks_h = _host(out)    # one host sync/tenant
                    _charge_wall(rep, self._dispatched, ("fused", m),
                                 time.monotonic() - t0)
                    ds.count(dispatches=1, syncs=1)
                    lengths[m_slots] += h
                    self._remaining[m_slots] -= h
                    served += len(m_slots)
                    for s in m_slots:
                        req = slots[s]
                        req.generated.extend(
                            int(t) for t in toks_h[:h, s])
                        pending[s] = int(toks_h[h - 1, s])
                        rep.model_tokens[m] += h
                        if req.done:
                            self._finish(s)
                else:
                    toks = np.where(act, pending, 0).astype(np.int32)
                    # page ids are tenant-local: blank out other
                    # tenants' rows so this backend never gathers past
                    # its pool
                    pt_m = np.where(act[:, None], page_table, TRASH_PAGE)
                    len_m = np.where(act, lengths, 0).astype(np.int32)
                    t0 = time.monotonic()
                    logits = backend.decode(toks, pt_m, len_m, act)
                    _charge_wall(rep, self._dispatched, ("decode", m),
                                 time.monotonic() - t0)
                    self._ds.count(dispatches=1, syncs=1,
                                   upload_bytes=page_table.nbytes)
                    lengths[m_slots] += 1
                    self._remaining[m_slots] -= 1
                    served += len(m_slots)
                    stoks = self._sample_batch(logits[m_slots])
                    for i, s in enumerate(m_slots):
                        req = slots[s]
                        tok = int(stoks[i])
                        req.generated.append(tok)
                        pending[s] = tok
                        rep.model_tokens[m] += 1
                        if req.done:
                            self._finish(s)
                # bounded slab: queue this burst's re-stream bytes
                pool.note_decode_burst(m)
            if served:
                did_compute = True
                rep.decode_steps += h
                rep.slot_steps += B * h
                rep.useful_slot_steps += served * h
            rep.peak_live_pages = max(
                rep.peak_live_pages,
                sum(a.live_count for a in allocs.values()))
            rep.peak_live_page_bytes = max(
                rep.peak_live_page_bytes,
                sum(a.live_count * self.backends[m].page_bytes
                    for m, a in allocs.items()))
            rep.peak_demand_pages = max(
                rep.peak_demand_pages,
                sum(a.demand_count for a in allocs.values()))
            rep.peak_demand_page_bytes = max(
                rep.peak_demand_page_bytes,
                sum(a.demand_count * self.backends[m].page_bytes
                    for m, a in allocs.items()))
        elif not sched.exhausted:
            nxt = sched.next_arrival()
            if nxt is not None and nxt > self.step \
                    and not sched.ready_models():
                self.step = nxt     # idle: fast-forward to next arrival
                return True
            # ready work exists but is blocked (deferred activation /
            # page wait / an in-flight layer stream): let time pass
        else:
            return False            # drained: idle until more is injected

        # -- layer-stream progress: one step of DMA bandwidth --------
        if e.stream == "layer" and pool.streaming:
            if not did_compute:
                # prefetch miss: no decode work hides the DMA, so the
                # engine idles a step waiting on the stream head
                head = pool.stream_head
                rep.stall_steps += 1
                rep.stall_steps_by_model[head] += 1
            pool.stream_tick()      # one step of the DMA channel's clock

        # -- arena bookkeeping: watermarks + epoch repartition -------
        # Shrink floor: an ADMITTED request was judged feasible against
        # its tenant's lease at admission; repartitioning must never cut
        # the lease below what the largest in-flight request still needs
        # to finish, or admission feasibility silently stops implying
        # completability (lease churn strands requests in preempt loops)
        for m in self.page_split:
            floor = 0
            for s in range(B):
                r = slots[s]
                if r is None or r.model_id != m:
                    continue
                R = self.backends[m].ring_rows
                demand = self._pgr[m].pages_for(
                    len(r.prompt) + r.max_new_tokens - 1)
                floor = max(floor, min(demand, R) if R else demand)
            self.arena.set_demand_floor(m, floor)
        self.arena.sample()
        if self.arena.maybe_repartition(self.step) is not None:
            # epoch boundary: weight-region occupancy joins the KV
            # invariants maybe_repartition already asserted
            self.arena.check(slab_used=pool.slab_used,
                             pinned_bytes=pool.plan.pinned_bytes)

        self.step += 1
        self._rr_left -= 1
        if self.step > e.max_steps:
            raise RuntimeError("pooled engine exceeded max_steps")
        return True

    def finish_run(self) -> PooledReport:
        pool, rep = self.pool, self._rep
        for m, sharer in self._sharers.items():
            sharer.index.release_all(self._allocs[m])
        self.arena.check(slab_used=pool.slab_used,
                         pinned_bytes=pool.plan.pinned_bytes)
        for a in self._allocs.values():
            assert a.live_count == 0, "pages leaked past completion"
        rep.preemptions = self._sched.preemptions
        rep.reload_bytes = pool.reload_bytes_total
        rep.restream_bytes = pool.restream_bytes_total
        rep.reload_events = pool.reload_events
        rep.evictions = pool.evictions
        rep.deferred_activations = pool.deferred_activations
        rep.repartitions = self.arena.repartitions
        rep.pages_moved = self.arena.pages_moved
        rep.device_dispatches = self._ds.device_dispatches
        rep.host_syncs = self._ds.host_syncs
        rep.page_table_upload_bytes = self._ds.page_table_upload_bytes
        rep.wall_s = time.monotonic() - self._t_run
        return rep

    def run(self, requests: list[Request]) -> PooledReport:
        self.start(requests)
        while self.step_once():
            pass
        return self.finish_run()


# --- static lockstep baseline --------------------------------------------------


def run_static(cfg, params, requests: list[Request], *, num_slots: int = 8,
               greedy: bool = True, temperature: float = 0.8,
               seed: int = 0) -> EngineReport:
    """The lockstep baseline: requests are taken in arrival order in
    fixed batches; each batch prefills together and decodes until the
    *longest* generation in the group finishes, over a dense cache of
    batch x (max prompt + max gen). Mixed prompt lengths are left-padded
    with no pad masking, as in the reference; the metrics are structural
    (steps and bytes), not a quality reference. Requests' ``extras``
    (whisper's ``frames``) are stacked into the batch; a group must carry
    the same extra keys throughout."""
    api = get_model(cfg)
    dev = params["embed"].device
    requests = sorted(requests, key=lambda r: r.arrival)
    rep = EngineReport(name=f"static/{cfg.name}", num_slots=num_slots)
    sample_batch = make_batch_sampler(np.random.default_rng(seed), greedy,
                                      temperature)
    dispatched: set = set()            # decode shapes already warmed up

    t_run = time.monotonic()
    step = 0
    for i in range(0, len(requests), num_slots):
        group = requests[i:i + num_slots]
        step = max(step, max(r.arrival for r in group))
        plen = max(len(r.prompt) for r in group)
        gen = max(r.max_new_tokens for r in group)
        cache_len = plen + gen
        toks = np.zeros((len(group), plen), np.int32)
        for b, r in enumerate(group):
            toks[b, plen - len(r.prompt):] = r.prompt   # left-pad
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        extra_keys = set().union(*(set(r.extras or {}) for r in group))
        missing = [r.rid for r in group
                   if set(r.extras or {}) != extra_keys]
        if missing:
            raise ValueError(
                f"requests {missing} lack extras {sorted(extra_keys)} their "
                f"batch group carries (static groups must be uniform)")
        batch.update({k: torch.as_tensor(
            np.stack([r.extras[k] for r in group]), device=dev)
            for k in extra_keys})
        t0 = time.monotonic()
        logits, state = api.prefill(cfg, params, batch, cache_len)
        toks0 = sample_batch(_host(L.whole_vocab(logits, cfg.vocab_size)))
        rep.prefill_wall_s += time.monotonic() - t0
        for b, r in enumerate(group):
            r.admitted_step = step
            r.generated.append(int(toks0[b]))
        rep.prefill_calls += 1
        rep.prefill_tokens += plen * len(group)   # padded compute is paid
        rep.cache_bytes_alloc = max(rep.cache_bytes_alloc,
                                    _state_bytes(state))
        for _ in range(gen - 1):        # lockstep drain to the longest
            tok = torch.as_tensor([r.generated[-1] for r in group],
                                  dtype=torch.int32, device=dev)
            t0 = time.monotonic()
            logits, state = api.decode_step(cfg, params, state, tok)
            logits = _host(L.whole_vocab(logits, cfg.vocab_size))
            _charge_wall(rep, dispatched, ("static", cache_len, len(group)),
                         time.monotonic() - t0)
            rep.decode_steps += 1
            rep.slot_steps += len(group)
            step += 1
            toks = sample_batch(logits)
            for b, r in enumerate(group):
                if not r.done:
                    r.generated.append(int(toks[b]))
                    rep.useful_slot_steps += 1
        del state
        for r in group:
            r.done_step = step          # results return with the batch
            rep.completed.append(r)
    rep.wall_s = time.monotonic() - t_run
    return rep
