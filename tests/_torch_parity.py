"""Shared harness of the port's engine tests: the JAX ``Engine`` and the
port's ``Engine`` on one seeded trace, reduced config, converted weights.

Requests end by token budget, so the schedule does not depend on token
values: the ledger (admission and done steps, preemptions, pages,
prefill tokens, dispatch/sync/upload counts) must match exactly. Token
streams must be equal or, where they differ, teacher-forced greedy-
consistent at bf16 (README "Prefix sharing", *Numerics*): every token the
port chose sits within a few bf16 quanta of the argmax of the
reference's clean run at that position — the full-sequence forward for
the dense, vlm (with the request's patch embeddings) and ssm families,
and for a routed (MoE) model the static path at B = 1
(``prefill`` of the prompt, then ``decode_step`` per token), which routes
as the engine does: the forward's prefill capacity would drop generated
tokens that dropless decode kept.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jget_model
from repro.runtime import Engine as JEngine
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.runtime import Engine, EngineConfig
from repro_torch.runtime import scheduler as tsched

REPORT_FIELDS = (
    "decode_steps", "slot_steps", "useful_slot_steps", "prefill_calls",
    "prefill_tokens", "preemptions", "peak_live_pages", "shared_page_hits",
    "cow_copies", "prefill_tokens_saved", "peak_demand_pages", "page_bytes",
    "slot_state_bytes", "cache_bytes_alloc", "kv_bytes_peak",
    "device_dispatches", "host_syncs", "page_table_upload_bytes",
    "new_tokens")
REQUEST_FIELDS = ("rid", "arrival", "admitted_step", "done_step", "prefills",
                  "truncated", "shared_pages", "cow_copies")
# the reference's own churn bound (test_runtime.py): 0.0625 in logits of
# order 1-4 is a few bf16 quanta; KV corruption shows as O(1) gaps
GREEDY_GAP = 0.0625


def setup(arch="codeqwen1.5-7b", seed=0):
    jcfg = jget(arch).reduced()
    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced()
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def run_port(cfg, params, trace, **ecfg):
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny CPU ops: no thread-pool contention
    try:
        return Engine(cfg, params, EngineConfig(**ecfg)).run(
            copy.deepcopy(trace))
    finally:
        torch.set_num_threads(n)


def ledger(rep) -> dict:
    out = {f: getattr(rep, f) for f in REPORT_FIELDS}
    out["requests"] = sorted(tuple(getattr(r, f) for f in REQUEST_FIELDS)
                             for r in rep.completed)
    return out


def teacher_forced_logits(jcfg, jp, prompt, generated, extras=None
                          ) -> np.ndarray:
    """The reference's logits (len(generated), V) before each generated
    token, with the generated tokens fed back: the full-sequence forward
    (given the request's ``extras``) for the dense, vlm and ssm families,
    the static prefill + per-token decode for a routed model."""
    api = jget_model(jcfg)
    if jcfg.moe is None:
        seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
        batch = {"tokens": seq, **{k: jnp.asarray(v)[None]
                                   for k, v in (extras or {}).items()}}
        logits = api.forward(jcfg, jp, batch)[0]
        return np.asarray(logits, np.float64)[len(prompt) - 1:-1]
    prefill, decode_step = _jitted_static(jcfg)
    # one cache length for most requests: one compile serves them all
    cache_len = -(-(len(prompt) + len(generated)) // 64) * 64
    logits, state = prefill(
        jp, {"tokens": jnp.asarray([list(prompt)], jnp.int32)},
        cache_len=cache_len)
    rows = [np.asarray(logits[0], np.float64)]
    for t in generated[:-1]:
        logits, state = decode_step(jp, state, jnp.asarray([t], jnp.int32))
        rows.append(np.asarray(logits[0], np.float64))
    return np.stack(rows)


@functools.lru_cache(maxsize=8)
def _jitted_static(jcfg):
    """The reference's static prefill and decode step, compiled as its
    run_static compiles them."""
    api = jget_model(jcfg)
    return (jax.jit(functools.partial(api.prefill, jcfg),
                    static_argnames=("cache_len",)),
            jax.jit(functools.partial(api.decode_step, jcfg)))


def greedy_gap(jcfg, jp, req) -> float:
    """Largest gap between the reference's max logit and the logit of the
    token ``req`` generated, over its generated positions."""
    rows = teacher_forced_logits(jcfg, jp, req.prompt, req.generated,
                                 req.extras)
    return max(float(row.max() - row[t])
               for row, t in zip(rows, req.generated))


def static_teacher_gap(jcfg, jp, group) -> float:
    """The reference's static path on one lockstep group of finished
    requests (left-padded prompts and the requests' extras stacked, as
    run_static batches them), teacher-forced with the port's tokens: the
    largest gap between a step's max logit and the logit of the token
    the port chose there."""
    jm = jget_model(jcfg)
    plen = max(len(r.prompt) for r in group)
    gen = max(r.max_new_tokens for r in group)
    toks = np.zeros((len(group), plen), np.int32)
    for b, r in enumerate(group):
        toks[b, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(np.stack([r.extras[k] for r in group]))
                for k in (group[0].extras or {})}}
    logits, state = jm.prefill(jcfg, jp, batch, plen + gen)
    gap = 0.0
    for j in range(gen):
        rows = np.asarray(logits, np.float64)
        for b, r in enumerate(group):
            if j < len(r.generated):
                gap = max(gap, rows[b].max() - rows[b, r.generated[j]])
        if j == gen - 1:
            break
        feed = [r.generated[min(j, len(r.generated) - 1)] for r in group]
        logits, state = jm.decode_step(jcfg, jp, state,
                                       jnp.asarray(feed, jnp.int32))
    return gap


def traces(kind: str, **kw):
    """The same seeded trace from both packages' trace generators
    (``kind`` names the generator, e.g. "poisson_trace")."""
    return getattr(jsched, kind)(**kw), getattr(tsched, kind)(**kw)


def assert_engines_agree(trace_kind: str, trace_kw: dict, *,
                         arch="codeqwen1.5-7b", jrep=None, models=None,
                         **ecfg):
    """Run both engines on one seeded trace, each built by its own
    package; return (jax report, port report). ``jrep`` reuses a JAX
    engine run of the same trace and config; ``models`` a ``setup(arch)``
    result. ``trace_kw`` may name an ``extras_fn`` (vlm patches)."""
    jcfg, jp, cfg, tp = models or setup(arch)
    jtrace, ttrace = traces(trace_kind, vocab_size=cfg.vocab_size,
                            **trace_kw)
    if jrep is None:
        jrep = JEngine(jcfg, jp, JEngineConfig(**ecfg)).run(jtrace)
    trep = run_port(cfg, tp, ttrace, **ecfg)
    assert ledger(trep) == ledger(jrep)
    jtok = {r.rid: r.generated for r in jrep.completed}
    for r in trep.completed:
        if r.generated != jtok[r.rid]:
            gap = greedy_gap(jcfg, jp, r)
            assert gap <= GREEDY_GAP, (r.rid, gap)
    return jrep, trep


# --- routed models: the reference disagrees with itself near a tie ----------------

TOL_BF16 = dict(rtol=4e-2, atol=4e-2)


def both_runs(fn, *args, **kw):
    """The reference function's compiled run (XLA fuses the scanned
    layers) and its op-by-op run (``jax.disable_jit``)."""
    out = fn(*args, **kw)
    with jax.disable_jit():
        return out, fn(*args, **kw)


def close_to_reference(got, compiled, eager):
    """Routing near a tie follows bf16 rounding, and the reference's
    compiled run rounds elsewhere than its op-by-op run, so the two can
    pick different experts for a token whose router probabilities tie
    within rounding (then its logits differ by O(0.4)). The port must
    match the op-by-op run everywhere, and the compiled run on every row
    where the reference's two runs agree."""
    got, compiled, eager = (np.asarray(a, np.float32)
                            for a in (got, compiled, eager))
    np.testing.assert_allclose(got, eager, **TOL_BF16)
    agree = np.all(np.isclose(compiled, eager, **TOL_BF16),
                   axis=tuple(range(1, got.ndim)))
    np.testing.assert_allclose(got[agree], compiled[agree], **TOL_BF16)
    assert agree.any()


# --- a pooled engine's schedule without weights ------------------------------------


class LedgerBackend:
    """An engine backend that holds no weights and no cache: each tenant's
    geometry (paged or not, page bytes, per-slot state bytes, routing)
    is its real backend's, prefill returns flat logits and a fused
    horizon advances the loop tensors as ``decode_loop_step`` does, every
    sampled token 1. A pooled engine's schedule, and so every count of
    its ledger, does not depend on token values: patched in for
    ``engine.resolve_backend``, it gives a full-width run's ledger on the
    CPU in seconds."""

    ring_rows = None
    prefix_sharing = False

    def __init__(self, cfg, params, ecfg):
        from repro_torch.models import moe

        self.cfg, self.ecfg = cfg, ecfg
        self.device = torch.device("cpu")
        self.paged = cfg.family != "ssm"
        self.routed = cfg.family == "moe"
        self.last_route_trace = None
        self.page_bytes = 0
        if cfg.family == "dense":
            self.page_bytes = ecfg.pager.page_bytes(cfg)
        elif cfg.family == "moe":
            self.page_bytes = (cfg.num_layers * ecfg.page_size
                               * moe.latent_width(cfg) * 2)
        B, L = ecfg.num_slots, cfg.num_layers
        self.slot_state_bytes = 0 if self.paged else 2 * (
            2 * L * B * cfg.d_model
            + L * B * cfg.num_heads * cfg.head_dim ** 2) + 4
        self.state = ()
        self.graph = None

    def can_ever_fit(self, pgr, prompt_len, max_new_tokens, ctx_len):
        return pgr.can_ever_fit(prompt_len, max_new_tokens, ctx_len,
                                pgr.num_pages)

    def admission_rows(self, pgr, ctx_len):
        return list(range(pgr.pages_for(ctx_len)))

    def prefill(self, ctx, extras, slot, pages, replay=None):
        return np.zeros((2,), np.float32)

    def release_slot(self, slot):
        pass

    def decode(self, tokens, page_table, lengths, active):
        return np.zeros((len(tokens), 2), np.float32)

    def decode_fused(self, pending, lengths, remaining, table, mask, h,
                     teacher=None):
        mask = torch.as_tensor(mask)
        out = torch.zeros((self.ecfg.horizon, len(pending)),
                          dtype=torch.int32)
        for i in range(h):
            live = (mask & (remaining > 0)).to(torch.int32)
            out[i] = live
            pending.copy_(torch.where(live.bool(), 1, pending))
            lengths.add_(live)
            remaining.sub_(live)
        return out


def chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only): its (k)/(k') settings."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_pool_setup(monkeypatch):
    """(k)'s zoo at full width with ``LedgerBackend`` tenants: the
    settings module, configs, tenants, the entry point's auto-sized
    PoolConfig and (weightless) params."""
    from repro_torch.launch import serve
    from repro_torch.runtime import engine
    cs = chip_smoke()
    monkeypatch.setattr(engine, "resolve_backend", lambda cfg: LedgerBackend)
    args = serve.parse_args(["--mode", "pool", "--full", "--zoo",
                             cs.POOL_ZOO, "--device", "cpu"])
    zoo, cfgs, tenants = serve.zoo_configs(args)
    pcfg = serve.pool_config(cfgs, args)
    return cs, zoo, cfgs, tenants, pcfg, {a: {} for a in cfgs}


# --- training: losses and gradients against the reference's --------------------------

#: losses: the bf16 TOL, relative
LOSS_RTOL = 2e-2


def train_batch(cfg, batch_size=2, seq_len=16, seed=0) -> dict:
    """A training batch as numpy arrays from a seed: tokens and their
    next-token labels, with the family's extras (frames, 4 patch
    embeddings)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch_size, seq_len + 1)
                        ).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (batch_size, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (batch_size, 4, cfg.d_model)).astype(np.float32)
    return b


def flat(tree, prefix="") -> dict:
    """A nested dict of arrays or tensors as {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def reference_loss_and_grads(jcfg, jp, nb, *, remat=False, eager=False,
                             routes=None):
    """The reference's ``jax.value_and_grad`` of its ``loss_fn``: (loss,
    {path: f64 grad}). ``eager``: op by op (``jax.disable_jit``);
    ``routes``: op by op with its MoE layers' expert choices taken from
    ``routes`` (``reference_routes``)."""
    api = jget_model(jcfg)
    batch = {k: jnp.asarray(v) for k, v in nb.items()}

    def run():
        return jax.value_and_grad(
            lambda p: api.loss_fn(jcfg, p, batch, remat=remat))(jp)
    if routes is not None:
        with reference_routes(routes), jax.disable_jit():
            loss, g = run()
    elif eager:
        with jax.disable_jit():
            loss, g = run()
    else:
        loss, g = run()
    return float(loss), {k: np.asarray(v, np.float64)
                         for k, v in flat(g).items()}


# --- MoE routing: near a tie, the two packages may pick different experts ----------

@contextlib.contextmanager
def port_routes():
    """Record each call of the port's ``layers.moe_ffn`` while the block
    runs: a list of (router probabilities (N, E), expert choices (N, k)),
    as numpy, computed as ``moe_ffn`` computes them."""
    from repro_torch.models import layers as L

    seen, moe_ffn = [], L.moe_ffn

    def recorded(x2d, p, dims, **kw):
        with torch.no_grad():
            probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
            seen.append((probs.numpy(),
                         torch.topk(probs, dims.top_k, dim=-1)[1].numpy()))
        return moe_ffn(x2d, p, dims, **kw)
    L.moe_ffn = recorded
    try:
        yield seen
    finally:
        L.moe_ffn = moe_ffn


class _PinnedTopK:
    """``jax.lax`` whose ``top_k`` returns the next recorded choices (and
    the probabilities it was given at them), recording what it saw."""

    def __init__(self, picks, seen):
        self.picks, self.seen = list(picks), seen

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, probs, k):
        if not isinstance(probs, jax.core.Tracer):
            self.seen.append(np.asarray(probs))
        idx = jnp.asarray(self.picks.pop(0))
        assert idx.shape == (probs.shape[0], k), idx.shape
        return jnp.take_along_axis(probs, idx, axis=-1), idx


@contextlib.contextmanager
def reference_routes(picks):
    """Op by op (use with ``jax.disable_jit``, so each MoE layer calls
    ``top_k`` once, in order), the reference's ``moe_ffn`` routes its
    tokens to ``picks`` (one (N, k) array a call, e.g. the port's from
    ``port_routes``) instead of its own top-k; yields the list of the
    router probabilities it computed (calls outside a gradient trace).
    Every pick must be used."""
    import repro.models.layers as JL

    shim = _PinnedTopK(picks, [])
    JL.lax = shim
    try:
        yield shim.seen
    finally:
        JL.lax = jax.lax
    assert not shim.picks, f"{len(shim.picks)} routes left unused"


def routes_differ_at_ties_only(port, reference_probs) -> int:
    """Each token whose chosen experts differ between the port's routing
    and the reference's own top-k of its probabilities (computed on the
    same routing history) must sit at a near-tie: the reference's margin
    between its k-th and (k+1)-th probability at most twice the largest
    difference of the two packages' probabilities at that token, which
    is when rounding can reorder them; and no probability may differ by
    more than 1e-2 (a few bf16 quanta). Returns the number of such
    tokens."""
    flips = 0
    for (probs, idx), ref_probs in zip(port, reference_probs, strict=True):
        k = idx.shape[1]
        order = np.argsort(-ref_probs, axis=-1, kind="stable")
        differ = np.any(np.sort(order[:, :k], -1) != np.sort(idx, -1), -1)
        ranked = np.take_along_axis(ref_probs, order, axis=-1)
        margin = ranked[:, k - 1] - ranked[:, k]
        dp = np.abs(probs - ref_probs).max(-1)
        assert dp.max() <= 1e-2, dp.max()
        assert np.all(margin[differ] <= 2 * dp[differ]), (margin[differ],
                                                          dp[differ])
        flips += int(differ.sum())
    return flips


def port_loss_and_grads(cfg, jp, nb, *, remat=False):
    """The port's ``loss_fn`` and autograd on the reference's params as
    f32 masters (``params_from_jax(master=True)``, ``compute_view``):
    (loss, {path: f64 grad})."""
    from repro_torch.convert import compute_view
    from repro_torch.models import get_model

    master = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             master=True)
    leaves = flat(master)
    for t in leaves.values():
        t.requires_grad_(True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = get_model(cfg).loss_fn(
            cfg, compute_view(master),
            {k: torch.tensor(v) for k, v in nb.items()}, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    finally:
        torch.set_num_threads(n)
    return float(loss.detach()), {
        k: (np.zeros(t.shape) if g is None else g.double().numpy())
        for (k, t), g in zip(leaves.items(), grads)}
