"""The fused horizon's CUDA-graph runner (``runtime.DecodeGraph``) on the
CPU: its step body, run eagerly through its static buffers, against the
eager loop ``multi_step_decode`` that the reference's fused horizon is
held against, for reduced codeqwen1.5-7b (paged K/V, paged-decode op) and
reduced deepseek-v2-lite-16b (latent pages, routed experts).

Both sides run the same step function on the same CPU tensors, so tokens,
loop tensors and KV pools must be equal bit for bit. The loop body they
share (``layers.decode_loop_step``) is also held against the reference's
``multi_step_decode`` on a stub step function. The graphs
themselves (capture, replay, launch counts) need the card:
``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe, transformer
from repro_torch.runtime import DecodeGraph

ARCHS = ["codeqwen1.5-7b", "deepseek-v2-lite-16b"]
B, PAGE, M, HMAX = 4, 4, 6, 5


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param).reduced()
    api = {"dense": transformer, "moe": moe}[cfg.family]
    params = api.init_params(cfg, seed=0, device="cpu")
    state = api.init_paged_decode_state(cfg, 1 + B * M, PAGE, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for pool in vars(state).values():       # a cache full of context
        pool.copy_(torch.randn(pool.shape, generator=gen).to(pool.dtype))
    return cfg, api, params, state


def _loop_tensors(cfg):
    """Slot 0 mid-context, slot 1 masked out, slot 2 with a budget that
    runs out inside the horizon, slot 3 on an empty cache."""
    rng = np.random.default_rng(2)
    table = torch.tensor(1 + rng.permutation(B * M).reshape(B, M),
                         dtype=torch.int32)
    return dict(
        pending=torch.tensor(rng.integers(0, cfg.vocab_size, B),
                             dtype=torch.int32),
        lengths=torch.tensor([9, 3, 14, 0], dtype=torch.int32),
        remaining=torch.tensor([8, 8, 2, 8], dtype=torch.int32),
        page_table=table,
        mask=torch.tensor([True, False, True, True]))


def _eager(cfg, api, params, state, t, h, teacher):
    return api.paged_decode_multi(
        cfg, params, state, t["pending"], t["lengths"], t["remaining"],
        t["page_table"], t["mask"], h, hmax=HMAX, teacher=teacher)


def _graph_body(cfg, api, params, state):
    def step(toks, pt, lens, act):
        return api.paged_decode_step(cfg, params, state, toks, pt, lens, act)
    return DecodeGraph(step, B, M, HMAX, "cpu")


@pytest.mark.parametrize("h,teach", [(HMAX, False), (2, False),
                                     (HMAX, True), (3, True)])
def test_step_body_equals_multi_step_decode(model, h, teach):
    """Two horizons back to back (the second continues from the first's
    loop tensors and pools): tokens, pending, lengths, remaining and every
    KV pool equal, with h at and below hmax, with and without a teacher."""
    cfg, api, params, state = model
    rng = np.random.default_rng(h)
    want_state, got_state = copy.deepcopy(state), copy.deepcopy(state)
    want_t, got_t = _loop_tensors(cfg), _loop_tensors(cfg)
    runner = _graph_body(cfg, api, params, got_state)
    assert not runner.graphed                   # no card: the eager body
    for _ in range(2):
        teacher = torch.tensor(rng.integers(0, cfg.vocab_size, (HMAX, B)),
                               dtype=torch.int32) if teach else None
        want = _eager(cfg, api, params, want_state, want_t, h, teacher)
        got = runner.run(got_t["pending"], got_t["lengths"],
                         got_t["remaining"], got_t["page_table"],
                         got_t["mask"], h, teacher)
        assert torch.equal(got, want)
        for k in ("pending", "lengths", "remaining"):
            assert torch.equal(got_t[k], want_t[k]), k
        for k, pool in vars(want_state).items():
            assert torch.equal(getattr(got_state, k), pool), k
    assert runner.horizons == 2 and runner.replays == 0
    assert torch.all(got[h:] == 0) and torch.all(got[:, 1] == 0)
    if teach:       # slot 0 stays live for 3 steps of either horizon
        n = min(h, 3)
        assert torch.equal(got[:n, 0], teacher[:n, 0])


V = 97      # prime: the stub's logits are a permutation of 0..V-1, no ties


def _stub_logits(xp, toks, pt, lens):
    """A step function's logits that depend on the fed token, the length
    and the (masked) page table row, the same in both packages."""
    v = xp.arange(V)
    key = toks * 31 + lens * 7 + pt[:, 0] * 3
    return (key[:, None] + v[None, :] * 13) % V


@pytest.mark.parametrize("runner", ["multi_step_decode", "DecodeGraph"])
@pytest.mark.parametrize("h,teach", [(HMAX, False), (2, False),
                                     (HMAX, True), (1, True)])
def test_loop_step_matches_reference(runner, h, teach):
    """The port's loop body, through ``multi_step_decode`` and through the
    graph runner's static buffers, against the reference's
    ``multi_step_decode`` (one ``lax.fori_loop``) on a stub step function:
    the same tokens and loop tensors, with a masked slot, a budget that
    runs out, h below hmax and a teacher."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    rng = np.random.default_rng(5)
    pending = rng.integers(0, V, B).astype(np.int32)
    lengths = np.array([9, 3, 14, 0], np.int32)
    remaining = np.array([8, 8, 2, 8], np.int32)
    table = (1 + rng.permutation(B * M).reshape(B, M)).astype(np.int32)
    mask = np.array([True, False, True, True])
    teacher = rng.integers(0, V, (HMAX, B)).astype(np.int32) \
        if teach else None

    def jstep(state, toks, pt, lens, act):
        return _stub_logits(jnp, toks, pt, lens).astype(jnp.float32), state

    want = JL.multi_step_decode(
        jstep, HMAX, None, *map(jnp.asarray, (pending, lengths, remaining,
                                              table, mask)),
        jnp.asarray(h), None if teacher is None else jnp.asarray(teacher))

    def step(toks, pt, lens, act):
        return _stub_logits(torch, toks, pt, lens).to(torch.float32)

    t = [torch.tensor(a) for a in (pending, lengths, remaining)]
    tt = None if teacher is None else torch.tensor(teacher)
    if runner == "multi_step_decode":
        out = L.multi_step_decode(step, HMAX, *t, torch.tensor(table),
                                  torch.tensor(mask), h, tt)
    else:
        out = DecodeGraph(step, B, M, HMAX, "cpu").run(
            *t, torch.tensor(table), torch.tensor(mask), h, tt)
    for got, w in zip((out, *t), (want[0], *want[2:])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_run_refuses_what_was_not_captured(model):
    cfg, api, params, state = model
    t = _loop_tensors(cfg)
    runner = _graph_body(cfg, api, params, copy.deepcopy(state))
    with pytest.raises(ValueError, match="horizon"):
        runner.run(t["pending"], t["lengths"], t["remaining"],
                   t["page_table"], t["mask"], HMAX + 1)
    with pytest.raises(ValueError, match="page table"):
        runner.run(t["pending"], t["lengths"], t["remaining"],
                   t["page_table"][:, :2], t["mask"], 1)


def test_engine_on_the_cpu_decodes_eagerly(model):
    """On the CPU the engine's fused horizon is the eager loop: no graph
    runner is built."""
    from repro_torch.runtime import Engine, EngineConfig, poisson_trace
    cfg, api, params, _ = model
    engine = Engine(cfg, params, EngineConfig(
        num_slots=2, page_size=4, num_pages=17, max_pages_per_seq=8,
        prefill_bucket=8, horizon=4))
    trace = poisson_trace(3, mean_interarrival=1.0, prompt_lens=(5, 8),
                          gen_lens=(6,), vocab_size=cfg.vocab_size, seed=0)
    rep = engine.run(trace)
    assert len(rep.completed) == 3 and engine.backend.graph is None


def test_capture_keeps_the_garbage_collector_out(monkeypatch):
    """A dropped backend and its DecodeGraph form a reference cycle, and
    collecting one inside another graph's capture resets its CUDA graph,
    which invalidates that capture on the card: ``capture`` turns the
    cyclic collector off for the capture and back on after it, also when
    the capture raises. (The capture itself is stubbed: no card here.)"""
    import gc

    seen = []

    class Capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            seen.append(gc.isenabled())

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    runs = []
    dg = DecodeGraph(lambda *a: runs.append(1), 2, 3, 4, "cpu")
    monkeypatch.setattr(dg, "body", lambda: runs.append(1))
    assert gc.isenabled()
    dg.capture()
    assert seen == [False] and gc.isenabled() and runs == [1]

    def fail():
        raise RuntimeError("capture failed")
    monkeypatch.setattr(dg, "body", fail)
    with pytest.raises(RuntimeError, match="capture failed"):
        dg.capture()
    assert seen == [False, False] and gc.isenabled()
