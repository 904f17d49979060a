"""The port's fleet tier against the JAX package's, on the same seeded
inputs (reduced configs, CPU): model placement, the chaos schedule's
grammar and queries, the retry and straggler policies, and
``FleetEngine`` on a diurnal trace under chaos (see _torch_parity for
the standard: reports exactly equal, tokens equal or greedy-consistent
at bf16)."""

import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (GREEDY_GAP, chip_pool_setup,  # noqa: E402
                           greedy_gap, setup)
from repro import runtime as J  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro_torch import runtime as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

KiB = 1 << 10
ZOO = (("codeqwen1.5-7b", 2.0), ("deepseek-v2-lite-16b", 1.0),
       ("rwkv6-7b", 1.0))


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- placement -----------------------------------------------------------------


def _descs(pkg, rng, n):
    return [pkg.ModelDesc(f"m{i}", None,
                          demand=float(rng.integers(1, 9)),
                          weight_bytes=int(rng.integers(50, 400)) * KiB,
                          value_per_byte=float(rng.uniform(0.5, 8.0)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["demand", "mirror"])
def test_place_models_matches_the_reference(seed, policy):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    for n_rep, cap, copies, fill in ((2, 700, 2, 0.62), (3, 500, 2, 0.62),
                                     (4, 900, 1, 0.8), (2, 300, 1, 0.5)):
        args = dict(policy=policy, min_copies=copies, fill_frac=fill)
        r = np.random.default_rng(seed)
        mine = T.place_models(_descs(T, r, n), n_rep, cap * KiB, **args)
        r = np.random.default_rng(seed)
        want = J.place_models(_descs(J, r, n), n_rep, cap * KiB, **args)
        assert mine == want


@pytest.mark.parametrize("reduced", [True, False])
def test_zoo_descs_and_placement_of_the_chip_zoo(reduced):
    """The chip's zoo, reduced and at full width: the probe-pack's
    descriptors and both placements equal the reference's."""
    def zoo(get):
        return [(a, get(a).reduced() if reduced else get(a), s)
                for a, s in ZOO]
    budget = (1000 * KiB) if reduced else int(76.7e9)
    pcfg_t = T.PoolConfig(hbm_budget_bytes=budget, slab_frac=0.5)
    pcfg_j = J.PoolConfig(hbm_budget_bytes=budget, slab_frac=0.5)
    mine, want = T.zoo_descs(zoo(get_config), pcfg_t), \
        J.zoo_descs(zoo(jget), pcfg_j)
    strip = [(d.model_id, d.demand, d.weight_bytes, d.value_per_byte)
             for d in want]
    assert [(d.model_id, d.demand, d.weight_bytes, d.value_per_byte)
            for d in mine] == strip
    for policy in ("demand", "mirror"):
        for copies in (1, 2):
            assert T.place_models(mine, 2, budget, policy=policy,
                                  min_copies=copies) == \
                J.place_models(want, 2, budget, policy=policy,
                               min_copies=copies)


# --- the fault layer -----------------------------------------------------------

SPECS = ("kill@120:r1,dma@200:r0x4/100,straggle@300:r2x3/50",
         "kill@5:r0", "dma@0:r0x8/400", "straggle@0:r0x4/500",
         "dma@10:r1x4/60,straggle@20:r2x3/60,kill@40:r0", "")


def _events(sched):
    return [(e.step, e.kind, e.target, e.factor, e.duration)
            for e in sched.events]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedule_parse_round_trips_like_the_reference(spec):
    mine, want = T.FaultSchedule.parse(spec), J.FaultSchedule.parse(spec)
    assert _events(mine) == _events(want)
    assert mine.spec == want.spec
    assert _events(T.FaultSchedule.parse(mine.spec)) == _events(mine)
    assert bool(mine) == bool(want)
    for step in (0, 5, 40, 119, 120, 250, 400):
        for tgt in ("r0", "r1", "r2"):
            assert [e.spec for e in mine.events_at(step, tgt)] == \
                [e.spec for e in want.events_at(step, tgt)]
            for kind in ("dma", "straggle"):
                assert mine.factor(kind, tgt, step) == \
                    want.factor(kind, tgt, step)
            assert mine.killed(tgt, step) == want.killed(tgt, step)


@pytest.mark.parametrize("seed", range(5))
def test_fault_schedule_random_matches_the_reference(seed):
    kw = dict(n_events=6, horizon=64, targets=("r0", "r1", "r2"),
              max_kills=1)
    mine, want = T.FaultSchedule.random(seed, **kw), \
        J.FaultSchedule.random(seed, **kw)
    assert _events(mine) == _events(want)
    assert mine.spec == want.spec
    assert _events(T.FaultSchedule.parse(mine.spec)) == _events(mine)
    assert sum(e.kind == "kill" for e in mine.events) <= 1


def test_fault_events_backoff_and_straggler_policy_match_the_reference():
    with pytest.raises(ValueError):
        T.FaultSchedule.parse("dma@3:r0x2")      # a window needs /duration
    with pytest.raises(AssertionError):
        T.FaultEvent(step=0, kind="melt", target="r0")
    b, jb = T.Backoff(base=1, factor=2.0, cap=16), \
        J.Backoff(base=1, factor=2.0, cap=16)
    assert [b.delay(i) for i in range(8)] == [jb.delay(i) for i in range(8)]
    rng = np.random.default_rng(0)
    d, jd = T.StragglerDetector(3.0, 8), J.StragglerDetector(3.0, 8)
    for x in rng.exponential(1.0, 60):
        assert d.observe(float(x)) == jd.observe(float(x))
        assert d.median() == jd.median()
    assert issubclass(T.TransientFault, RuntimeError)
    assert T.TRANSIENT_DEFAULT[:2] == (T.StepTimeout, T.TransientFault)


# --- FleetEngine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_models():
    return {a: setup(a) for a, _ in ZOO}


def _fleet(pkg, models, which, zoo, trace, fcfg_kw, spec):
    cfgs = {a: models[a][which] for a, _ in zoo}
    pcfg = pkg.PoolConfig(hbm_budget_bytes=700 * KiB, slab_frac=0.5,
                          reload_bytes_per_step=32 * KiB,
                          hysteresis_steps=8)
    ecfg = pkg.PoolEngineConfig(num_slots=4, page_size=8, num_pages=65,
                                max_pages_per_seq=8, prefill_bucket=8,
                                stream="layer")
    fleet = pkg.FleetEngine(
        [(a, cfgs[a], s) for a, s in zoo], pcfg, ecfg,
        {a: models[a][which + 1] for a, _ in zoo},
        pkg.FleetConfig(n_replicas=2, **fcfg_kw),
        faults=pkg.FaultSchedule.parse(spec) if spec else None)
    return fleet.run(copy.deepcopy(trace)), fleet


FLEETS = {
    "demand-chaos": ((("codeqwen1.5-7b", 2.0), ("rwkv6-7b", 1.0)), {},
                     "dma@1:r0x4/20,straggle@2:r1x2/6,kill@5:r0"),
    "mirror-clean": (ZOO, dict(placement="mirror"), ""),
}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_engine_matches_the_reference(case, zoo_models):
    """``FleetReport.summary()`` equal field for field (placement,
    failovers, re-admissions, retries, queue ages, per-replica rows), no
    request lost, and the tokens equal or greedy-consistent."""
    zoo, fkw, spec = FLEETS[case]
    tenants = [dict(model_id=a, vocab_size=256, share=s) for a, s in zoo]
    kw = dict(mean_interarrival=0.4, prompt_lens=(6, 10),
              gen_lens=(3, 6, 12), seed=3)
    trep, _ = _fleet(T, zoo_models, 2, zoo,
                     T.diurnal_trace(tenants, 20, **kw), fkw, spec)
    jrep, _ = _fleet(J, zoo_models, 0, zoo,
                     J.diurnal_trace(tenants, 20, **kw), fkw, spec)
    assert trep.summary() == jrep.summary()
    assert trep.requests_lost == 0
    assert trep.re_admission_order == jrep.re_admission_order
    assert trep.re_admission_latency == jrep.re_admission_latency
    assert sorted(r.rid for r in trep.completed) == \
        sorted(r.rid for r in jrep.completed)
    if spec:
        assert trep.failovers == 1 and trep.re_admissions >= 1
    jtok = {r.rid: r.generated for r in jrep.completed}
    for r in trep.completed:
        if r.generated != jtok[r.rid]:
            jcfg, jp = zoo_models[r.model_id][:2]
            gap = greedy_gap(jcfg, jp, r)
            if gap > GREEDY_GAP and jcfg.moe is not None:
                with jax.disable_jit():     # see test_torch_pool._gap
                    gap = greedy_gap(jcfg, jp, r)
            assert gap <= GREEDY_GAP, (r.rid, r.model_id, gap)


def test_fleet_claims_in_the_port(zoo_models):
    """bench_serve's fleet claims at the chip smoke test's shape (its zoo,
    the auto budget ``serve`` sizes, the H100 clock, two replicas, queues
    capped at 8, a 24-request diurnal trace), reduced, in the port alone:
    demand placement at one copy a model (so it differs from mirror)
    ahead of mirror on tokens/step with fewer reload bytes and the same
    tokens; the chaos run at the reference's two copies (every model on
    both replicas here) loses nothing, re-admits r1's work and keeps the
    p99 queue age within 10x the clean run's; the replicas' engines share
    one params dict."""
    import argparse

    from repro_torch.launch import serve
    cfgs = {a: zoo_models[a][2] for a, _ in ZOO}
    params = {a: zoo_models[a][3] for a, _ in ZOO}
    pcfg = serve.pool_config(cfgs, argparse.Namespace(
        slab_frac=0.5, hbm_budget_kib=0, reload_kib_per_step=0,
        hysteresis=32, slab_mode="full", quant="off"))
    assert pcfg.reload_bytes_per_step == \
        T.calibrated_reload_bytes_per_step(cfgs.items())
    tenants = [dict(model_id=a, vocab_size=256, share=s) for a, s in ZOO]
    trace = T.diurnal_trace(tenants, 24, mean_interarrival=0.3,
                            prompt_lens=(6, 10), gen_lens=(3, 6, 12),
                            seed=3)
    ecfg = T.PoolEngineConfig(num_slots=4, page_size=8, num_pages=49,
                              max_pages_per_seq=8, prefill_bucket=8,
                              stream="layer")

    def run(spec="", **fkw):
        fleet = T.FleetEngine([(a, cfgs[a], s) for a, s in ZOO], pcfg, ecfg,
                              params, T.FleetConfig(
                                  n_replicas=2, max_queue_per_replica=8,
                                  **fkw),
                              faults=T.FaultSchedule.parse(spec)
                              if spec else None)
        for r in fleet.replicas:
            for m in r.models:
                assert r.engine.backends[m].params is params[m]
        return fleet.run(copy.deepcopy(trace))

    demand = run(min_copies=1)
    mirror = run(placement="mirror")
    chaos = run("kill@10:r1,dma@2:r0x4/100")
    assert demand.placement != mirror.placement == chaos.placement
    toks = [{r.rid: r.generated for r in rep.completed}
            for rep in (demand, mirror, chaos)]
    assert toks[0] == toks[1] == toks[2]
    assert demand.tokens_per_step > mirror.tokens_per_step
    assert demand.reload_bytes < mirror.reload_bytes
    assert chaos.requests_lost == 0 and chaos.requests_shed == 0
    assert chaos.failovers == 1 and chaos.re_admissions >= 1
    assert chaos.queue_age_percentile(99) <= \
        10 * max(mirror.queue_age_percentile(99), 1.0)


def test_chip_fleet_ledger_at_full_width(monkeypatch):
    """chip_smoke (k')'s three fleet runs at full width without weights
    (``LedgerBackend``, as test_torch_pool's (k) twin): the placements,
    tokens/step, reload bytes and the chaos run's failover,
    re-admissions and p99 queue-age factor the card gives."""
    cs, zoo, cfgs, tenants, pcfg, params = chip_pool_setup(monkeypatch)
    trace = cs.pool_trace(T, tenants, "diurnal_trace", 0.5)

    def run(spec="", **fkw):
        return T.FleetEngine(
            [(a, cfgs[a], s) for a, s in zoo], pcfg,
            cs.pool_engine_config(T, stream="layer"), params,
            T.FleetConfig(n_replicas=2, max_queue_per_replica=8, **fkw),
            faults=T.FaultSchedule.parse(spec) if spec else None
        ).run(copy.deepcopy(trace))

    demand = run(min_copies=1)
    mirror = run(placement="mirror")
    chaos = run(cs.FLEET_CHAOS)
    assert demand.placement == {"codeqwen1.5-7b": [0],
                                "deepseek-v2-lite-16b": [1],
                                "rwkv6-7b": [0, 1]}
    assert mirror.placement == chaos.placement == {
        a: [0, 1] for a, _ in zoo}
    assert (round(demand.tokens_per_step, 3), demand.reload_bytes) == \
        (1.404, 29896998912)
    assert (round(mirror.tokens_per_step, 3), mirror.reload_bytes) == \
        (1.348, 59793997824)
    assert (chaos.failovers, chaos.re_admissions, chaos.requests_lost,
            chaos.requests_shed) == (1, 8, 0, 0)
    assert round(chaos.queue_age_percentile(99)
                 / mirror.queue_age_percentile(99), 3) == 2.29
