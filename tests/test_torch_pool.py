"""The port's multi-tenant pool against the JAX package's, on the same
seeded inputs (reduced configs, CPU): the residency planner, the pool's
packing, the device arena's epochs, the DMA channel's ledger, and
``PooledEngine`` across the policy / stream / repartition / slab / quant
settings (see _torch_parity for the standard: ledgers exactly equal,
tokens equal or greedy-consistent at bf16)."""

import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (GREEDY_GAP, chip_pool_setup,  # noqa: E402
                           greedy_gap, setup)
from repro import runtime as J  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.planner import residency as jres  # noqa: E402
from repro_torch import runtime as T  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.planner import residency as tres  # noqa: E402
from repro_torch.runtime import model_pool as tpool  # noqa: E402

KiB = 1 << 10
ARCHS = sorted(REGISTRY)
# the chip smoke test's zoo: paged (dense), latent-page (MLA-MoE) and
# recurrent backends, with codeqwen carrying twice the traffic
ZOO = (("codeqwen1.5-7b", 2.0), ("deepseek-v2-lite-16b", 1.0),
       ("rwkv6-7b", 1.0))
FIVE = ("codeqwen1.5-7b", "qwen2-vl-7b", "rwkv6-7b", "recurrentgemma-9b",
        "deepseek-v2-lite-16b")
# full-width serving copies in GB (the reference's model_weight_bytes)
FULL_GB = {"codeqwen1.5-7b": 16.38, "qwen2-vl-7b": 15.23, "rwkv6-7b": 13.05,
           "recurrentgemma-9b": 19.14, "deepseek-v2-lite-16b": 32.42,
           "olmoe-1b-7b": 13.84}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, reduced):
    cfg, jcfg = get_config(arch), jget(arch)
    return (cfg.reduced(), jcfg.reduced()) if reduced else (cfg, jcfg)


# --- residency planner ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_weight_inventory_matches_the_reference(arch, reduced):
    """The port's configs give the planner the reference's fields (the
    recurrence's block pattern and width, MLA, MoE, encoder, tied
    embeddings): the same tensors and the same weight bytes."""
    cfg, jcfg = _pair(arch, reduced)
    got = [(t.name, t.params, t.reuse, t.tp_shardable)
           for t in tres.weight_inventory(cfg)]
    want = [(t.name, t.params, t.reuse, t.tp_shardable)
            for t in jres.weight_inventory(jcfg)]
    assert got == want
    assert tpool.model_weight_bytes(cfg) == J.model_weight_bytes(jcfg)
    if not reduced and arch in FULL_GB:
        assert round(tpool.model_weight_bytes(cfg) / 1e9, 2) == FULL_GB[arch]


@pytest.mark.parametrize("quant", tres.QUANT_MODES)
def test_layer_schedule_matches_the_reference(quant):
    for arch in ARCHS:
        for reduced in (False, True):
            cfg, jcfg = _pair(arch, reduced)
            got = tres.layer_schedule(cfg, quant=quant)
            want = jres.layer_schedule(jcfg, quant=quant)
            assert [(s.name, s.nbytes, s.precision, s.stream_nbytes())
                    for s in got] == \
                [(s.name, s.nbytes, s.precision, s.stream_nbytes())
                 for s in want]
            sizes = [s.stream_nbytes() for s in got]
            assert tres.double_buffer_bytes(sizes) == \
                jres.double_buffer_bytes(sizes)
    for nbytes in (0, 1, 255, 4096, 10 ** 9 + 7):
        for prec in ("fp", "int8", "int4"):
            assert tres.quant_bytes(nbytes, prec) == \
                jres.quant_bytes(nbytes, prec)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_residency_matches_the_reference(arch):
    cfg, jcfg = _pair(arch, False)
    for tp, dp, train, hbm in ((1, 1, False, 80.0), (8, 1, False, 16.0),
                               (4, 16, True, 16.0), (16, 16, True, 95.0)):
        got = tres.plan_residency(cfg, tp=tp, dp=dp, train=train,
                                  hbm_gb=hbm)
        want = jres.plan_residency(jcfg, tp=tp, dp=dp, train=train,
                                   hbm_gb=hbm)
        assert got.summary() == want.summary()
        assert got.stream_bytes_per_step == want.stream_bytes_per_step


# --- the pool's packing and its reload clock ----------------------------------------


def _pools(zoo, reduced, **pkw):
    """The same zoo registered in both packages' pools, packed."""
    out = []
    for pkg, get in ((T, get_config), (J, jget)):
        pool = pkg.ModelPool(pkg.PoolConfig(**pkw))
        for arch, share in zoo:
            cfg = get(arch)
            pool.register(arch, cfg.reduced() if reduced else cfg,
                          demand=share)
        pool.pack()
        out.append(pool)
    return out


PACKINGS = [dict(hbm_budget_bytes=b * KiB, slab_frac=s, slab_mode=m,
                 quant=q)
            for b, s, m, q in ((700, 0.55, "full", "off"),
                               (700, 0.4, "bounded", "off"),
                               (600, 0.55, "full", "int8"),
                               (768, 0.4, "bounded", "int4"),
                               (2000, 0.5, "full", "auto"),
                               (200, 0.25, "full", "off"))]


@pytest.mark.parametrize("pkw", PACKINGS,
                         ids=[f"{p['hbm_budget_bytes'] >> 10}k-"
                              f"{p['slab_frac']}-{p['slab_mode']}-"
                              f"{p['quant']}" for p in PACKINGS])
def test_pack_summary_matches_the_reference(pkw):
    """``PoolPlan.summary()`` and every entry's reload schedule and
    hideable tail, on the five-family zoo and on the chip's zoo."""
    for zoo in ([(a, 1.0) for a in FIVE], ZOO):
        mine, ref = _pools(zoo, True, reload_bytes_per_step=32 * KiB,
                           **pkw)
        assert mine.plan.summary() == ref.plan.summary()
        for e, f in zip(mine.plan.entries, ref.plan.entries):
            assert e.reload_schedule == f.reload_schedule
            assert e.restream_bytes == f.restream_bytes
            assert e.hideable_bytes(32 * KiB) == f.hideable_bytes(32 * KiB)


def test_pack_at_full_width_matches_the_reference():
    """The chip's zoo at full width (61.85 GB of bf16 weights) under the
    auto budget ``serve`` computes: the same plan in both packages."""
    w = sum(FULL_GB[a] for a, _ in ZOO if a in FULL_GB) * 1e9
    budget = 1024 + int(max(0.62 * w / 0.5, 32.42e9 / 0.5))
    mine, ref = _pools(ZOO, False, hbm_budget_bytes=budget, slab_frac=0.5,
                       reload_bytes_per_step=300 << 20)
    assert mine.plan.summary() == ref.plan.summary()
    assert {e.residency for e in mine.plan.entries} != {"resident"}


def test_calibrated_clock_is_the_h100s():
    """One H100's decode-step bound (weight bytes at the HBM rate) and its
    host link give every arch the same steps to reload, HBM rate over
    link rate; the reduced zoo's serving copies reload in that many
    steps, and the module reads no artifact file."""
    steps = tpool.HBM_BYTES_PER_S / tpool.HOST_LINK_BYTES_PER_S
    assert 53.0 < steps < 53.3
    assert tpool.HOST_LINK_BYTES_PER_S == pytest.approx(63.015e9, rel=1e-4)
    zoo = [(a, get_config(a).reduced()) for a, _ in ZOO]
    want = sorted(tpool.model_weight_bytes(c) / steps for _, c in zoo)[1]
    assert T.calibrated_reload_bytes_per_step(zoo) == int(want)
    full = [(a, get_config(a)) for a, _ in ZOO]
    assert T.calibrated_reload_bytes_per_step(full) == int(
        16379289600 / steps)
    assert tpool.decode_step_bound_s(get_config("codeqwen1.5-7b")) == \
        pytest.approx(16379289600 / 3.35e12)
    src = open(tpool.__file__).read()
    for word in ("benchmarks/", "open(", "json", "50e9"):
        assert word not in src, word
    with pytest.raises(ValueError):
        T.calibrated_reload_bytes_per_step([])


# --- the device arena ------------------------------------------------------------


def _arena_walk(pkg, seed: int, repartition: str):
    """A seeded walk of alloc / free / starve / floor / epoch ops over a
    three-tenant arena with unequal page sizes; returns the summaries
    taken at every step."""
    rng = np.random.default_rng(seed)
    pb = {"a": 128, "b": 64, "c": 32}
    arena = pkg.DeviceArena(
        pkg.ArenaConfig(kv_pages=49, repartition=repartition,
                        epoch_steps=4, pin_bytes=1000, slab_bytes=500),
        {"a": 3.0, "b": 1.0, "c": 1.0})
    for t, b in pb.items():
        arena.register_page_bytes(t, b)
    owners = {t: 0 for t in arena.tenants}
    seen = [arena.summary()]
    for step in range(1, 120):
        for t in arena.tenants:
            alloc = arena.allocator(t)
            op = int(rng.integers(0, 8))
            if op <= 2:
                n = int(rng.integers(1, 4))
                if alloc.can_alloc(n):
                    owners[t] += 1
                    alloc.alloc(owners[t], n)
                else:
                    arena.note_starved(t, step, want=n)
            elif op <= 5 and owners[t]:
                o = int(rng.integers(1, owners[t] + 1))
                if alloc.owned(o):
                    alloc.free_owner(o)
            elif op == 6:
                arena.set_demand_floor(t, int(rng.integers(0, 4)))
        arena.sample()
        moves = arena.maybe_repartition(step)
        arena.check(slab_used=int(rng.integers(0, 501)), pinned_bytes=1000)
        seen.append((step, moves, arena.summary(),
                     {t: (arena.lease(t), arena.cap(t),
                          arena.allocator(t).live_count)
                      for t in arena.tenants}))
    epochs = arena.repartitions
    arena.reset_runtime()
    arena.check()
    seen.append(arena.summary())
    return seen, epochs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("repartition", ["off", "epoch"])
def test_arena_epochs_match_the_reference(seed, repartition):
    mine, epochs = _arena_walk(T, seed, repartition)
    ref, _ = _arena_walk(J, seed, repartition)
    assert mine == ref
    assert (epochs > 0) == (repartition == "epoch")
    assert T.partition_pages(97, {"a": 2.0, "b": 1.0, "c": 1.5}) == \
        J.partition_pages(97, {"a": 2.0, "b": 1.0, "c": 1.5})


# --- the DMA channel's ledger ---------------------------------------------------


def _dma_walk(ch, seed: int) -> list:
    """A seeded walk of enqueue / tick / cancel / charge / clock ops; every
    return value and the ledger after each op, ``check()`` throughout."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(300):
        op = int(rng.integers(0, 8))
        owner = "m" + str(int(rng.integers(0, 4)))
        if op <= 1:
            ch.enqueue(owner, int(rng.integers(1, 400)))
            r = None
        elif op <= 3:
            r = ch.tick(None if op == 2 else int(rng.integers(0, 300)))
        elif op == 4:
            r = ch.cancel(owner)
        elif op == 5:
            ch.charge_reload(int(rng.integers(0, 100)))
            ch.charge_restream(int(rng.integers(0, 50)))
            r = None
        elif op == 6:
            ch.degrade(float(rng.choice([1.0, 2.0, 3.5, 8.0])))
            r = None
        else:
            if rng.random() < 0.1:
                ch.reset()
            else:
                ch.set_clock(int(rng.integers(1, 200)))
            r = None
        ch.check()
        out.append((op, r, ch.queue, ch.head,
                    {m: ch.remaining(m) for m in ch.queue},
                    ch.ready(owner, 50), ch.in_flight(owner),
                    ch.bytes_per_step, ch.base_bytes_per_step,
                    ch.degrade_factor, ch.reload_bytes_total,
                    ch.restream_bytes_total, ch.reload_events))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dma_ledger_matches_the_reference(seed):
    """FIFO order, the byte clock, ``degrade``, ``cancel``, the reload
    and restream counters and ``check()``: the port's channel is the
    reference's, and the device channel (synchronous copies on the CPU)
    keeps the same ledger, one copy a byte-moving tick, no stall."""
    want = _dma_walk(J.DmaChannel(64), seed)
    assert _dma_walk(T.DmaChannel(64), seed) == want
    dev = T.DeviceDmaChannel(64, slab_bytes=256, device="cpu")
    got = _dma_walk(dev, seed)
    assert got == want
    dev.check()
    assert dev.measured_stall_steps == 0 and dev.measured_wait_s == 0.0
    assert dev.copies_issued <= sum(1 for w in want if w[0] in (2, 3))


def test_device_channel_copies_each_ticked_byte_on_the_cpu():
    dev = T.DeviceDmaChannel(100, device="cpu")
    dev.enqueue("a", 250)
    assert [dev.tick() for _ in range(4)] == [100, 100, 50, 0]
    assert dev.copies_issued == 3 and dev.copied_bytes == 250
    assert bool((dev._slabs[0][:50] == 1).all())
    dev.check()
    dev.reset()
    dev.check()
    assert dev.copies_issued == 0 and dev.queue == ()
    pool = T.ModelPool(T.PoolConfig(hbm_budget_bytes=700 * KiB,
                                    device_dma=True, dma_device="cpu"))
    assert isinstance(pool.dma, T.DeviceDmaChannel)
    assert isinstance(pool, T.WeightStream)


# --- PooledEngine ---------------------------------------------------------------

POOL_FIELDS = ("stall_steps", "stall_steps_by_model", "reload_bytes",
               "restream_bytes", "reload_events", "evictions",
               "deferred_activations", "repartitions", "pages_moved",
               "aging_blocks", "model_tokens", "device_dispatches",
               "host_syncs", "page_table_upload_bytes", "decode_steps",
               "prefill_tokens", "prefill_calls", "preemptions",
               "new_tokens", "kv_bytes_peak", "kv_demand_bytes_peak",
               "tokens_per_step", "decode_tokens_per_step",
               "wasted_slot_fraction", "requests", "policy", "stream",
               "p50", "p95", "shared_page_hits", "cow_copies",
               "prefill_tokens_saved")
REPORT_FIELDS = ("slot_steps", "useful_slot_steps", "peak_live_pages",
                 "peak_demand_pages", "peak_live_page_bytes",
                 "peak_demand_page_bytes", "page_bytes", "slot_state_bytes",
                 "cache_bytes_alloc")
REQUEST_FIELDS = ("rid", "model_id", "arrival", "admitted_step",
                  "done_step", "prefills", "truncated")


@pytest.fixture(scope="module")
def zoo_models():
    return {a: setup(a) for a, _ in ZOO}


def _ledger(rep) -> dict:
    s = rep.summary()
    out = {f: s[f] for f in POOL_FIELDS}
    out.update({f: getattr(rep, f) for f in REPORT_FIELDS})
    out["requests"] = sorted(tuple(getattr(r, f) for f in REQUEST_FIELDS)
                             for r in rep.completed)
    return out


def _pool_run(pkg, models, which, trace, pkw, ekw, zoo=ZOO):
    """One pooled run; ``which`` picks (cfg, params) from a setup()
    tuple: 0/1 for the reference, 2/3 for the port."""
    pool = pkg.ModelPool(pkg.PoolConfig(**pkw))
    for arch, share in zoo:
        pool.register(arch, models[arch][which], demand=share)
    eng = pkg.PooledEngine(pool, {a: models[a][which + 1] for a, _ in zoo},
                           pkg.PoolEngineConfig(**ekw))
    return eng.run(copy.deepcopy(trace)), eng, pool


def assert_pools_agree(models, trace_kind, trace_kw, pkw, ekw, zoo=ZOO):
    """Both packages' PooledEngine on one seeded trace: equal ledgers
    (every summary field but the wall clocks, the per-request admission
    and done steps), tokens equal or greedy-consistent."""
    tenants = [dict(model_id=a, vocab_size=256, share=s) for a, s in zoo]
    jtrace = getattr(J, trace_kind)(tenants, **trace_kw)
    ttrace = getattr(T, trace_kind)(tenants, **trace_kw)
    jrep, _, _ = _pool_run(J, models, 0, jtrace, {
        k: v for k, v in pkw.items() if k != "dma_device"}, ekw, zoo)
    trep, eng, pool = _pool_run(T, models, 2, ttrace, pkw, ekw, zoo)
    assert _ledger(trep) == _ledger(jrep)
    jtok = {r.rid: r.generated for r in jrep.completed}
    for r in trep.completed:
        if r.generated != jtok[r.rid]:
            gap = _gap(models[r.model_id], r)
            assert gap <= GREEDY_GAP, (r.rid, r.model_id, gap)
    return jrep, trep, eng, pool


def _gap(model, req) -> float:
    """``greedy_gap`` against the reference's clean run. The routed tenant
    is held as ``close_to_reference`` holds its logits: routing near a tie
    follows bf16 rounding, and where the reference's compiled run rounds
    the other way, against its op-by-op run (``jax.disable_jit``)."""
    jcfg, jp = model[:2]
    gap = greedy_gap(jcfg, jp, req)
    if gap > GREEDY_GAP and jcfg.moe is not None:
        with jax.disable_jit():
            gap = greedy_gap(jcfg, jp, req)
    return gap


TRACE = dict(n_requests=16, mean_interarrival=0.4, prompt_lens=(6, 10),
             gen_lens=(3, 6, 12), seed=3)
POOL = dict(hbm_budget_bytes=700 * KiB, slab_frac=0.55,
            reload_bytes_per_step=32 * KiB, hysteresis_steps=8)
ENGINE = dict(num_slots=4, page_size=8, num_pages=49, max_pages_per_seq=8,
              prefill_bucket=8)
SETTINGS = {
    # policy: model-granular reloads, the reload-aware loop vs the naive
    # round-robin swap
    "reload_aware-model": ({}, dict(stream="model")),
    "round_robin-model": ({}, dict(policy="round_robin", stream="model",
                                   rr_quantum=8)),
    # stream: layer-granular streaming behind decode, through the device
    # channel (synchronous copies on the CPU)
    "reload_aware-layer-device_dma": (dict(device_dma=True,
                                           dma_device="cpu"),
                                      dict(stream="layer")),
    # repartition: arena epochs on the same trace
    "layer-epoch": ({}, dict(stream="layer", repartition="epoch",
                             epoch_steps=8)),
    # slab_mode: bounded double buffer with restreams
    "layer-bounded": (dict(slab_frac=0.4, slab_mode="bounded"),
                      dict(stream="layer")),
    # quant: int8 reload byte accounting
    "layer-int8": (dict(quant="int8"), dict(stream="layer")),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_pooled_engine_matches_the_reference(setting, zoo_models):
    pkw, ekw = SETTINGS[setting]
    _, trep, eng, pool = assert_pools_agree(
        zoo_models, "multi_tenant_trace", TRACE, {**POOL, **pkw},
        {**ENGINE, **ekw})
    assert len(trep.completed) == TRACE["n_requests"]
    assert all(v > 0 for v in trep.model_tokens.values())
    assert trep.reload_bytes > 0
    pool.dma.check()
    if setting == "round_robin-model":
        assert trep.evictions > 1 and trep.preemptions > 0
    if setting == "reload_aware-model":
        assert trep.deferred_activations > 0 and trep.stall_steps > 0
    if setting.startswith("reload_aware-layer"):
        assert isinstance(pool.dma, T.DeviceDmaChannel)
        assert pool.dma.copies_issued > 0
        assert pool.dma.measured_stall_steps == 0
    if setting == "layer-epoch":
        assert trep.repartitions > 0
    if setting == "layer-bounded":
        assert trep.restream_bytes > 0


def test_pooled_engine_shifting_mix_moves_pages_like_the_reference(
        zoo_models):
    """A shifting mix under a tight page budget: epoch repartitions move
    leases between tenants and preempt, with equal ledgers."""
    _, trep, _, _ = assert_pools_agree(
        zoo_models, "shifting_mix_trace",
        dict(n_requests=16, mean_interarrival=0.4, prompt_lens=(6, 10),
             gen_lens=(3, 6, 12), seed=3),
        POOL, {**ENGINE, "num_pages": 17, "stream": "layer",
               "repartition": "epoch", "epoch_steps": 8})
    assert trep.pages_moved > 0 and trep.preemptions > 0


def test_reload_aware_beats_round_robin_and_layer_beats_model(zoo_models):
    """The pool's claims (bench_serve's check()) on the reduced zoo, in the
    port alone: the same tokens, reload-aware ahead on tokens/step with
    fewer reload bytes, layer streaming with fewer stall steps."""
    tenants = [dict(model_id=a, vocab_size=256, share=s) for a, s in ZOO]
    trace = T.multi_tenant_trace(tenants, **TRACE)
    reps = {}
    for name, ekw in (("ra", dict(stream="model")),
                      ("rr", dict(policy="round_robin", stream="model",
                                  rr_quantum=8)),
                      ("layer", dict(stream="layer"))):
        reps[name] = _pool_run(T, zoo_models, 2, trace, POOL,
                               {**ENGINE, **ekw})[0]
    toks = {k: {r.rid: r.generated for r in v.completed}
            for k, v in reps.items()}
    assert toks["ra"] == toks["rr"] == toks["layer"]
    assert reps["ra"].tokens_per_step > reps["rr"].tokens_per_step
    assert reps["ra"].reload_bytes < reps["rr"].reload_bytes
    assert reps["layer"].stall_steps < reps["ra"].stall_steps


def test_pool_serves_five_families_end_to_end():
    """The port's counterpart of the reference's five-family pool test:
    the dense/vlm/ssm/hybrid/moe zoo runs through ONE pooled engine,
    every tenant completes, and the paged tenants split the modeled page
    budget."""
    cfgs = {a: get_config(a).reduced() for a in FIVE}
    params = {a: get_model(c).init_params(c, seed=0, device="cpu")
              for a, c in cfgs.items()}
    tenants = [dict(model_id=a, vocab_size=c.vocab_size,
                    extras_fn=T.vlm_extras_fn(c) if c.family == "vlm"
                    else None)
               for a, c in cfgs.items()]
    pool = T.ModelPool(T.PoolConfig(hbm_budget_bytes=2000 * KiB,
                                    slab_frac=0.5,
                                    reload_bytes_per_step=32 * KiB,
                                    hysteresis_steps=8))
    for a, c in cfgs.items():
        pool.register(a, c)
    ecfg = T.PoolEngineConfig(num_slots=6, page_size=8, num_pages=97,
                              max_pages_per_seq=8, prefill_bucket=8)
    eng = T.PooledEngine(pool, params, ecfg)
    assert {cfgs[a].family for a in FIVE} == \
        {"dense", "vlm", "ssm", "hybrid", "moe"}
    trace = T.multi_tenant_trace(tenants, 15, mean_interarrival=0.4,
                                 prompt_lens=(6, 10), gen_lens=(3, 6),
                                 seed=3)
    rep = eng.run(copy.deepcopy(trace))
    assert len(rep.completed) == 15
    assert all(not r.truncated for r in rep.completed)
    assert all(len(r.generated) == r.max_new_tokens for r in rep.completed)
    served = {m for m, n in rep.model_tokens.items() if n > 0}
    assert {"hybrid", "moe"} <= {cfgs[a].family for a in served}
    phys = sum(eng.page_split[m] + 1 for m in eng.page_split)
    assert phys <= ecfg.num_pages
    assert set(eng.page_split) == {a for a in FIVE
                                   if cfgs[a].family != "ssm"}
    assert type(eng.backends["rwkv6-7b"]).__name__ == "RecurrentBackend"
    assert type(eng.backends["recurrentgemma-9b"]).__name__ == \
        "HybridBackend"


# --- two tenants in one fused step ------------------------------------------------


def test_two_tenant_fused_horizon_leaves_the_other_slots_alone(zoo_models):
    """Tenants chain through one DeviceLoopState: in one engine step each
    tenant's fused horizon advances its own slots and leaves every other
    slot's pending token, length and budget exactly as they were. Each
    horizon runs in the reference's step at the reference's h and mask
    and leaves the same lengths and budgets; the tokens are the
    reference's or greedy-consistent with its clean run."""
    zoo = (("codeqwen1.5-7b", 1.0), ("rwkv6-7b", 1.0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (7, 9, 6, 10)]
    big = dict(hbm_budget_bytes=4000 * KiB, slab_frac=0.3,
               reload_bytes_per_step=32 * KiB)
    calls, done = {}, {}
    for pkg, which in ((T, 2), (J, 0)):
        trace = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=12,
                             arrival=0, model_id=zoo[i % 2][0])
                 for i, p in enumerate(prompts)]
        pool = pkg.ModelPool(pkg.PoolConfig(**big))
        for arch, share in zoo:
            pool.register(arch, zoo_models[arch][which], demand=share)
        eng = pkg.PooledEngine(pool, {a: zoo_models[a][which + 1]
                                      for a, _ in zoo},
                               pkg.PoolEngineConfig(**ENGINE, horizon=8))
        log = calls[pkg] = []

        def wrap(fused, m, log=log, eng=eng, port=pkg is T):
            def call(pending, lengths, remaining, table, mask, h,
                     teacher=None):
                before = [np.asarray(t).copy()
                          for t in (pending, lengths, remaining)]
                res = fused(pending, lengths, remaining, table, mask, h,
                            teacher)
                after = [t.numpy().copy() if port else np.asarray(t)
                         for t in ((pending, lengths, remaining) if port
                                   else res[1:])]
                log.append((eng.step, m, np.asarray(mask).copy(), h,
                            before, after))
                return res
            return call

        for m, backend in eng.backends.items():
            backend.decode_fused = wrap(backend.decode_fused, m)
        done[pkg] = {r.rid: r for r in eng.run(trace).completed}
        assert len(done[pkg]) == 4
    mine, ref = calls[T], calls[J]
    assert len(mine) == len(ref) >= 2
    steps = [c[0] for c in mine]
    both = {s for s in steps if steps.count(s) == 2}
    assert both, "no engine step ran both tenants' horizons"
    assert any(c[3] > 1 for c in mine if c[0] in both)
    for (s, m, mask, h, before, after), (s2, m2, mask2, h2, _, jafter) \
            in zip(mine, ref):
        assert (s, m, h) == (s2, m2, h2)
        np.testing.assert_array_equal(mask, mask2)
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a[~mask], b[~mask])
        for a, ja in zip(after[1:], jafter[1:]):
            np.testing.assert_array_equal(a, ja)
    for rid, r in done[T].items():
        if r.generated != done[J][rid].generated:
            assert _gap(zoo_models[r.model_id], r) <= GREEDY_GAP, rid


# --- the chip smoke test's pool, at full width, without weights ---------------------


def test_chip_pool_ledger_at_full_width(monkeypatch):
    """chip_smoke (k)'s three pooled runs at full width: the schedule, and
    so every count of the ledger, does not depend on the tokens, so the
    weightless run here gives the ledger the card gives (NVIDIA H100,
    PERF.md §6): the auto budget and the H100 clock, deepseek
    streamed behind resident codeqwen and rwkv6, the stall steps, reload
    bytes, preemptions, steps, dispatches and syncs of each run."""
    cs, zoo, cfgs, tenants, pcfg, params = chip_pool_setup(monkeypatch)
    assert pcfg.reload_bytes_per_step == 308103651
    assert pcfg.hbm_budget_bytes == 76697867919
    trace = cs.pool_trace(T, tenants, "multi_tenant_trace", 4.0)

    def run(**ekw):
        pool = T.ModelPool(pcfg)
        for arch, share in zoo:
            pool.register(arch, cfgs[arch], demand=share)
        res = {e.model_id: e.residency for e in pool.pack().entries}
        assert res == {"codeqwen1.5-7b": "resident", "rwkv6-7b": "resident",
                       "deepseek-v2-lite-16b": "streamed"}
        return T.PooledEngine(pool, params, cs.pool_engine_config(
            T, **ekw)).run(copy.deepcopy(trace))

    def row(rep):
        s = rep.summary()
        return (s["tokens_per_step"], rep.stall_steps, rep.reload_bytes,
                rep.evictions, rep.preemptions, rep.decode_steps,
                rep.device_dispatches, rep.host_syncs, rep.new_tokens)

    ra = run(stream="model")
    rr = run(policy="round_robin", stream="model")
    lay = run(stream="layer")
    assert row(ra) == (1.486, 98, 29896998912, 0, 0, 326, 292, 214, 2176)
    assert row(rr) == (0.226, 1078, 328866988032, 11, 123, 539, 630, 524,
                       2176)
    assert row(lay) == (1.5, 0, 29896998912, 0, 2, 331, 531, 420, 2176)
