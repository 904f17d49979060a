"""The port's Engine on the MLA-MoE family (deepseek-v2-lite-16b, reduced)
through the latent-page backend: the JAX Engine's ledger on one seeded
trace, and the port's versions of the reference's latent-backend tests
(test_engine_families.py, test_horizon.py) — the static-path oracle,
routing at a tight capacity, preemption replaying routes, and the fused
horizon against per-step dispatch. See _torch_parity for the standard.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_engines_agree, setup, traces
from repro.runtime import Engine as JEngine
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import run_static as jrun_static
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.runtime import (ENGINE_FAMILIES, Engine, EngineConfig,
                                 LatentBackend, PagedTransformerBackend,
                                 RecurrentBackend, Request, engine_backend,
                                 poisson_trace, run_static)

ARCH = "deepseek-v2-lite-16b"
ECFG = EngineConfig(num_slots=2, page_size=8, num_pages=33,
                    max_pages_per_seq=8, prefill_bucket=8)
PREEMPTING = dict(n_requests=8, mean_interarrival=0.2, prompt_lens=(8, 16),
                  gen_lens=(24, 40), seed=1)
TINY_POOL = dict(num_slots=4, page_size=8, num_pages=17, max_pages_per_seq=8,
                 prefill_bucket=8)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return setup(ARCH)


@pytest.fixture(scope="module")
def jax_run(models):
    """One JAX engine run of the preempting trace, shared by the module."""
    jcfg, jp, cfg, _ = models
    jtrace, _ = traces("poisson_trace", vocab_size=cfg.vocab_size,
                       **PREEMPTING)
    return JEngine(jcfg, jp, JEngineConfig(**TINY_POOL)).run(jtrace)


def _prompt(key, n, vocab):
    """The reference tests' prompts (jax.random.randint)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), (n,), 0,
                                         vocab), np.int32)


def _static_oracle(cfg, params, prompt, gen):
    """Greedy continuation on the port's lockstep path (B = 1)."""
    api = get_model(cfg)
    logits, state = api.prefill(cfg, params,
                                {"tokens": torch.tensor(prompt[None])},
                                len(prompt) + gen)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(gen - 1):
        logits, state = api.decode_step(cfg, params, state,
                                        torch.tensor([toks[-1]]))
        toks.append(int(torch.argmax(logits[0])))
    return toks


def _engine_tokens(cfg, params, prompt, gen, ecfg=ECFG):
    rep = Engine(cfg, params, ecfg).run(
        [Request(rid=0, prompt=prompt.copy(), max_new_tokens=gen)])
    (req,) = rep.completed
    assert not req.truncated
    return req.generated, rep


def _toks(rep):
    return {r.rid: tuple(r.generated) for r in rep.completed}


def _steps(rep):
    return {r.rid: (r.admitted_step, r.done_step) for r in rep.completed}


def _pair(cfg, params, trace, ecfg=ECFG, horizon=16):
    """The same trace fused (horizon) and per-step (horizon=1)."""
    rf = Engine(cfg, params, dataclasses.replace(ecfg, horizon=horizon)).run(
        copy.deepcopy(trace))
    rs = Engine(cfg, params, dataclasses.replace(ecfg, horizon=1)).run(
        copy.deepcopy(trace))
    return rf, rs


# --- against the JAX engine ------------------------------------------------------


def test_latent_engine_matches_jax_engine(models, jax_run):
    """Ledger equality with preemption (fused horizons, tiny pool); tokens
    equal or greedy-consistent through the reference's static path. Every
    request recorded its route trace at its first prefill, at the
    reference's capacity, and re-prefills replayed it."""
    jrep, trep = assert_engines_agree("poisson_trace", PREEMPTING, arch=ARCH,
                                      jrep=jax_run, models=models,
                                      **TINY_POOL)
    assert trep.preemptions > 0 and trep.page_bytes == \
        2 * 8 * (32 + 8) * 2
    assert max(r.prefills for r in trep.completed) > 1
    jby = {r.rid: r for r in jrep.completed}
    for r in trep.completed:
        j = jby[r.rid].route_trace
        assert r.route_trace["capacity"] == j["capacity"]
        assert r.route_trace["keep"].shape == j["keep"].shape


def test_run_static_serves_deepseek_like_the_jax_baseline(models):
    """The static baseline dispatches through get_model: the same lockstep
    schedule as the reference's run_static on deepseek."""
    jcfg, jp, cfg, tp = models
    jtrace, ttrace = traces("poisson_trace", vocab_size=cfg.vocab_size,
                            n_requests=5, mean_interarrival=0.5,
                            prompt_lens=(6, 10), gen_lens=(3, 6), seed=4)
    jrep = jrun_static(jcfg, jp, jtrace, num_slots=2)
    trep = run_static(cfg, tp, ttrace, num_slots=2)
    for f in ("decode_steps", "slot_steps", "useful_slot_steps",
              "prefill_calls", "prefill_tokens", "new_tokens"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert sorted((r.rid, r.admitted_step, r.done_step)
                  for r in trep.completed) == \
        sorted((r.rid, r.admitted_step, r.done_step) for r in jrep.completed)


# --- test_engine_families.py, the latent backend -------------------------------------


def test_paged_backend_matches_static_oracle(models):
    """The engine's latent-page decode reproduces the static path's greedy
    trajectory token for token."""
    _, _, cfg, tp = models
    prompt = _prompt(7, 6, cfg.vocab_size)
    want = _static_oracle(cfg, tp, prompt, 8)
    got, rep = _engine_tokens(cfg, tp, prompt, 8)
    assert got == want
    assert rep.page_bytes > 0            # really paged, not static


def test_latent_engine_matches_oracle_at_tight_capacity(models):
    """A prompt whose routing overflows an expert at the arch's own
    capacity factor: the oracle's trajectory changes when capacity is
    relaxed (drops occur), and the engine, which pads the prompt to its
    bucket, still routes at the exact-length capacity and matches."""
    _, _, cfg, tp = models
    assert cfg.moe.capacity_factor <= 2.0
    prompt = _prompt(1, 6, cfg.vocab_size)
    want = _static_oracle(cfg, tp, prompt, 8)
    relaxed = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    assert _static_oracle(relaxed, tp, prompt, 8) != want, \
        "prompt does not overflow an expert: the differential is vacuous"
    got, rep = _engine_tokens(cfg, tp, prompt, 8)
    assert got == want
    assert rep.prefill_tokens > len(prompt)


def test_latent_preemption_replays_routing(models):
    """Preempting a routed request does not change its tokens: the
    re-prefill replays the first prefill's drop population."""
    _, _, cfg, tp = models
    prompt = _prompt(1, 6, cfg.vocab_size)

    def reqs():
        return [Request(rid=i, prompt=prompt.copy(), max_new_tokens=12)
                for i in range(2)]

    calm = Engine(cfg, tp, ECFG).run(reqs())
    assert calm.preemptions == 0
    tight = EngineConfig(num_slots=2, page_size=8, num_pages=4,
                         max_pages_per_seq=8, prefill_bucket=8)
    squeezed = Engine(cfg, tp, tight).run(reqs())
    assert squeezed.preemptions > 0
    assert max(r.prefills for r in squeezed.completed) > 1
    assert _toks(squeezed) == _toks(calm)


def test_backend_registry_and_error_message(models):
    """moe routes through the latent backend only with an MLA cache; the
    error for anything else lists the registry's families."""
    _, _, cfg, tp = models
    assert engine_backend(cfg) is LatentBackend
    assert engine_backend(get_config("codeqwen1.5-7b").reduced()) \
        is PagedTransformerBackend
    assert engine_backend(get_config("olmoe-1b-7b").reduced()) is None
    assert engine_backend(get_config("rwkv6-7b").reduced()) \
        is RecurrentBackend
    with pytest.raises(ValueError) as ei:
        Engine(get_config("olmoe-1b-7b").reduced(), tp, ECFG)
    assert "no engine backend" in str(ei.value)
    assert str(sorted(ENGINE_FAMILIES)) in str(ei.value)
    # prefix sharing stays dense-only: the latent backend ignores it
    rep = Engine(cfg, tp, dataclasses.replace(ECFG, prefix_sharing=True)
                 ).run([Request(rid=0, prompt=_prompt(7, 6, cfg.vocab_size),
                                max_new_tokens=4)])
    assert rep.shared_page_hits == 0 and rep.cow_copies == 0


# --- test_horizon.py, the latent backend --------------------------------------------


def test_fused_matches_per_step_with_arrivals(models):
    """Arrivals landing mid-horizon: identical tokens and admission and
    finish steps; fusion changes only the dispatch count."""
    _, _, cfg, tp = models
    trace = poisson_trace(6, mean_interarrival=0.5, prompt_lens=(6, 10),
                          gen_lens=(3, 8, 20), vocab_size=cfg.vocab_size,
                          seed=2)
    rf, rs = _pair(cfg, tp, trace)
    assert _toks(rf) == _toks(rs)
    assert _steps(rf) == _steps(rs)
    assert rf.device_dispatches < rs.device_dispatches
    assert rf.host_syncs < rs.host_syncs


def test_preemption_mid_trace_matches_per_step(models):
    """A pool too small for both requests forces preempt + replay; the
    freed slot caps the next horizon at 1, so re-admission lands on the
    per-step engine's step."""
    _, _, cfg, tp = models
    prompt = _prompt(1, 6, cfg.vocab_size)
    tight = EngineConfig(num_slots=2, page_size=8, num_pages=4,
                         max_pages_per_seq=8, prefill_bucket=8)
    trace = [Request(rid=i, prompt=prompt.copy(), max_new_tokens=12)
             for i in range(2)]
    rf, rs = _pair(cfg, tp, trace, ecfg=tight, horizon=16)
    assert rf.preemptions > 0 and rs.preemptions > 0
    assert _toks(rf) == _toks(rs)
    assert _steps(rf) == _steps(rs)
