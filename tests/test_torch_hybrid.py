"""recurrentgemma-9b (the hybrid family, Griffin) in the port against the
JAX package: its config and parameters, the causal conv and the RG-LRU
scan, prefill and decode on the static ring, the paged window ring
(prefill scatter and one decode step), the engine's hybrid backend (the
reference's hybrid cases of tests/test_engine_families.py and
tests/test_horizon.py: the static oracle, a prompt longer than the
window, paged logits against ring decode through a wrap, interleaved
requests against their solo runs, fused against per-step with arrivals
and a ring wrap inside a horizon), the CUDA-graph runner's step body,
the static path and the serving entry point. Reduced config (one (rec,
rec, attn) period, window 8), converted weights, inputs from numpy seeds.

Tolerances: the conv and the RG-LRU on the same f32 inputs within
tests/test_kernels.py's f32 TOL (rtol 1e-4, atol 2e-4). Logits and
states run in bf16 compute, which XLA rounds at other places than
PyTorch: the reference's own compiled and op-by-op forwards differ by
up to 0.060 in logits of order 3.6 here, so whole-prompt logits and
states are held within rtol = atol = 8e-2, and one decode step from a
shared state within rwkv6's 4e-2. Engine ledgers must be equal; tokens
equal or, where they differ, greedy-consistent within the repository's
greedy gap (_torch_parity).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (GREEDY_GAP, assert_engines_agree,  # noqa: E402
                           ledger, run_port, setup, static_teacher_gap,
                           traces)
from repro.configs import get_config as jget  # noqa: E402
from repro.models import griffin as JG  # noqa: E402
from repro.runtime import Engine as JEngine  # noqa: E402
from repro.runtime import EngineConfig as JEngineConfig  # noqa: E402
from repro.runtime import Request as JRequest  # noqa: E402
from repro.runtime import run_static as jrun_static  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import griffin as G  # noqa: E402
from repro_torch.models.transformer import F32_PARAMS  # noqa: E402
from repro_torch.runtime import (DecodeGraph, EngineConfig,  # noqa: E402
                                 HybridBackend, PageAllocator, Request,
                                 engine_backend, run_static)
from repro_torch.runtime import engine as E  # noqa: E402
from repro_torch.runtime import scheduler as tsched  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL32 = dict(rtol=1e-4, atol=2e-4)
TOL_STEP = dict(rtol=4e-2, atol=4e-2)
TOL_SEQ = dict(rtol=8e-2, atol=8e-2)
ECFG = dict(num_slots=2, page_size=8, num_pages=33, max_pages_per_seq=8,
            prefill_bucket=8)
TRACE = dict(n_requests=6, mean_interarrival=0.5, prompt_lens=(6, 10),
             gen_lens=(3, 8, 20), seed=2)


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


def _np(t):
    return t.float().numpy()


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _state_to_jax(ts) -> JG.GriffinState:
    return JG.GriffinState(
        conv=jnp.asarray(_np(ts.conv), jnp.bfloat16),
        h=jnp.asarray(ts.h.numpy()),
        k=jnp.asarray(_np(ts.k), jnp.bfloat16),
        v=jnp.asarray(_np(ts.v), jnp.bfloat16),
        kpos=jnp.asarray(ts.kpos.numpy()),
        pos=jnp.asarray(ts.pos, jnp.int32))


def _assert_state_close(ts, js, tol):
    assert ts.conv.dtype == torch.bfloat16 and ts.h.dtype == torch.float32
    for f in ("conv", "h", "k", "v"):
        np.testing.assert_allclose(_np(getattr(ts, f)),
                                   np.asarray(getattr(js, f), np.float32),
                                   **tol, err_msg=f)
    np.testing.assert_array_equal(ts.kpos.numpy(), np.asarray(js.kpos))
    assert ts.pos == int(js.pos)


def _static_oracle(cfg, params, prompt, gen):
    """Greedy continuation on the port's lockstep path (B = 1, no pad)."""
    api = get_model(cfg)
    logits, state = api.prefill(cfg, params, {"tokens": torch.as_tensor(
        prompt[None].astype(np.int32))}, len(prompt) + gen)
    toks = [int(logits[0].argmax())]
    for _ in range(gen - 1):
        logits, state = api.decode_step(cfg, params, state,
                                        torch.tensor([toks[-1]]))
        toks.append(int(logits[0].argmax()))
    return toks


# --- config and parameters ----------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    j, t = jget(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
              "use_bias", "tie_embeddings", "rope_theta", "mrope"):
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.recurrent) == dataclasses.asdict(t.recurrent)
    assert G._counts(t) == JG._counts(j)
    assert G._state_counts(t) == JG._state_counts(j)


def test_init_params_tree_and_dtypes_match_converted(models):
    """init_params draws the reference's tree (super.{rec1,rec2,attn}
    stacked over super-blocks) in the converter's dtypes: ``lam``, the
    norm scales ``ln`` / ``ln_mlp`` and ``ln_f`` in f32 (the reference
    passes them uncast), every other leaf in bf16."""
    jcfg, jp, cfg, tp = models
    mine = G.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == \
        jax.tree.map(lambda t: tuple(t.shape), mine)
    for path, t in jax.tree_util.tree_leaves_with_path(mine):
        name = path[-1].key
        want = torch.float32 if name in F32_PARAMS else torch.bfloat16
        assert t.dtype == want, path
    assert {"ln", "ln_mlp", "lam"} <= F32_PARAMS
    assert tp["super"]["rec1"]["lam"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["super"]["rec1"]["lam"].numpy(),
        np.asarray(jp["super"]["rec1"]["lam"], np.float32))
    lam = mine["super"]["rec1"]["lam"]
    assert 0.3 < lam.std().item() < 0.7          # trunc-normal, std 0.5


# --- the recurrent pieces -------------------------------------------------------------


@pytest.mark.parametrize("length", [None, 5, 8])
def test_causal_conv_matches_reference(length):
    """The depthwise causal conv and its carried register, with and
    without the ``length`` gate of a padded prompt (5 of 8 live; 8 the
    whole bucket), on the same f32 inputs."""
    rng = np.random.default_rng(3)
    x, w, b, st = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 8, 16), (4, 16), (16,), (2, 3, 16)))
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    tl = None if length is None else torch.tensor([length])
    jy, jst = JG._causal_conv(*map(jnp.asarray, (x, w, b, st)), length=jl)
    ty, tst = G._causal_conv(*map(torch.as_tensor, (x, w, b, st)),
                             length=tl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL32)


@pytest.mark.parametrize("length", [None, 3, 7])
def test_rglru_matches_reference(models, length):
    """The RG-LRU scan in f32 with the model's own ``lam``: the hidden
    sequence and the carried hidden, pad positions gated to identity."""
    _, jp, _, _ = models
    rng = np.random.default_rng(4)
    x, r, i = (rng.standard_normal((2, 7, 64)).astype(np.float32)
               for _ in range(3))
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    lam = np.asarray(jp["super"]["rec1"]["lam"][0], np.float32)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    tl = None if length is None else torch.tensor([length])
    jhs, jh = JG._rglru(*map(jnp.asarray, (x, r, i, lam, h0)), length=jl)
    ths, th = G._rglru(*(torch.tensor(a) for a in (x, r, i, lam, h0)),
                       length=tl)
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), **TOL32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL32)
    if length is not None:          # the carry is the state at ``length``
        _, h_at = G._rglru(*(torch.tensor(a[:, :length]) for a in (x, r, i)),
                           torch.tensor(lam), torch.tensor(h0))
        np.testing.assert_allclose(th.numpy(), h_at.numpy(), **TOL32)


# --- static prefill and ring decode -------------------------------------------------


@pytest.mark.parametrize("S", [5, 8, 12])
def test_forward_and_prefill_match_reference(models, S):
    """The full forward, and prefill's last logits and ring state, below
    the window (5), at it (8) and past it (12: the ring holds the last 8
    keys rolled to their slots, kpos exact)."""
    jcfg, jp, cfg, tp = models
    toks = _tokens(S, (2, S))
    jlog = JG.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tlog = G.forward(cfg, tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL_SEQ)
    jlast, jst = JG.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, S + 4)
    tlast, tst = G.prefill(cfg, tp, {"tokens": torch.as_tensor(toks)}, S + 4)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL_SEQ)
    _assert_state_close(tst, jst, TOL_SEQ)
    np.testing.assert_allclose(tlast.numpy(), tlog[:, -1].numpy(), **TOL32)


@pytest.mark.parametrize("S", [6, 11])
def test_decode_step_from_a_shared_state_matches_reference(models, S):
    """One decode step from the port's prefilled state (handed to the
    reference as is): logits and the advanced state, in place on the
    port's side; 11 wraps the ring."""
    jcfg, jp, cfg, tp = models
    _, ts = G.prefill(cfg, tp, {"tokens": torch.as_tensor(_tokens(S, (2, S)))})
    js = _state_to_jax(ts)
    conv_ptr = ts.conv.data_ptr()
    tok = _tokens(S + 1, (2,))
    jlog, js2 = JG.decode_step(jcfg, jp, js, jnp.asarray(tok))
    tlog, ts2 = G.decode_step(cfg, tp, ts, torch.as_tensor(tok))
    assert ts2 is ts and ts.conv.data_ptr() == conv_ptr
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL_STEP)
    _assert_state_close(ts2, js2, TOL_STEP)


# --- the paged window ring ---------------------------------------------------------------


def _paged_pair(cfg, jcfg, tp, jp, plen, page=4, num_pages=8, slot=1):
    """Both packages' paged states after one B = 1 prefill of ``plen``
    tokens scattered into its in-window pages at ``slot`` of 2."""
    toks = _tokens(plen, (1, plen))
    win = cfg.recurrent.window
    n_lo = max(0, plen - win) // page
    n_hi = (plen - 1) // page
    pids = np.zeros((plen // page,), np.int32)
    pids[n_lo:n_hi + 1] = np.arange(1, 2 + n_hi - n_lo)
    R = G.ring_rows(win, page)
    pt = np.zeros((2, R), np.int32)
    for n in range(n_lo, n_hi + 1):
        pt[slot, n % R] = pids[n]
    ts = G.init_paged_decode_state(cfg, 2, num_pages, page, device="cpu")
    tlast, tkv, tconv, th = G.paged_prefill(
        cfg, tp, {"tokens": torch.as_tensor(toks)}, torch.tensor([plen]))
    G.write_prefill_state(cfg, ts, (tkv[0][:, 0], tkv[1][:, 0]), tconv, th,
                          torch.as_tensor(pids), slot)
    js = JG.init_paged_decode_state(jcfg, 2, num_pages, page)
    jlast, jkv, jconv, jh = JG.paged_prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(plen, jnp.int32))
    js = JG.write_prefill_state(jcfg, js, (jkv[0][:, 0], jkv[1][:, 0]),
                                jconv, jh, jnp.asarray(pids), slot)
    return (tlast, ts), (jlast, js), pt


def _assert_paged_close(ts, js, tol):
    for f in ("conv", "h", "k_pages", "v_pages"):
        np.testing.assert_allclose(_np(getattr(ts, f)),
                                   np.asarray(getattr(js, f), np.float32),
                                   **tol, err_msg=f)


@pytest.mark.parametrize("plen", [8, 12])
def test_paged_prefill_and_one_step_match_reference(models, plen):
    """paged_prefill + write_prefill_state (12 > window: only the
    in-window pages are written), then one paged_decode_step from the
    port's state handed to the reference, slot 0 inactive (its recurrent
    state frozen, its write on the trash page)."""
    jcfg, jp, cfg, tp = models
    (tlast, ts), (jlast, js), pt = _paged_pair(cfg, jcfg, tp, jp, plen)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL_SEQ)
    _assert_paged_close(ts, js, TOL_SEQ)
    js = JG.GriffinPagedState(
        conv=jnp.asarray(_np(ts.conv), jnp.bfloat16), h=jnp.asarray(
            ts.h.numpy()), k_pages=jnp.asarray(_np(ts.k_pages), jnp.bfloat16),
        v_pages=jnp.asarray(_np(ts.v_pages), jnp.bfloat16))
    if plen % 4 == 0:               # the next token opens a fresh ring row
        pt[1, (plen // 4) % pt.shape[1]] = 7
    tok = np.array([0, 5], np.int32)
    lens = np.array([0, plen], np.int32)
    act = np.array([False, True])
    before = ts.conv[:, 0].clone(), ts.h[:, 0].clone()
    jlog, js2 = JG.paged_decode_step(jcfg, jp, js, jnp.asarray(tok),
                                     jnp.asarray(pt), jnp.asarray(lens),
                                     jnp.asarray(act))
    tlog = G.paged_decode_step(cfg, tp, ts, torch.as_tensor(tok),
                               torch.as_tensor(pt), torch.as_tensor(lens),
                               torch.as_tensor(act))
    np.testing.assert_allclose(tlog[1].numpy(), np.asarray(jlog[1]),
                               **TOL_STEP)
    _assert_paged_close(ts, js2, TOL_STEP)
    assert torch.equal(ts.conv[:, 0], before[0])        # frozen slot
    assert torch.equal(ts.h[:, 0], before[1])


def test_paged_ring_masks_rows_on_the_trash_page(models):
    """An in-window ring row left on the trash page (page 0, filled with
    large garbage in both packages) is masked out, as the reference
    masks it: the logits of one step agree with the reference's."""
    jcfg, jp, cfg, tp = models
    (_, ts), _, pt = _paged_pair(cfg, jcfg, tp, jp, 12)
    pt[1, 2] = 0                    # page 2 (positions 8-11) -> trash
    pt[1, 0] = 7                    # page 3 (position 12) opens row 0
    garbage = torch.full_like(ts.k_pages[:, :, 0], 30.0)
    ts.k_pages[:, :, 0] = garbage
    ts.v_pages[:, :, 0] = garbage
    js = JG.GriffinPagedState(
        conv=jnp.asarray(_np(ts.conv), jnp.bfloat16), h=jnp.asarray(
            ts.h.numpy()), k_pages=jnp.asarray(_np(ts.k_pages), jnp.bfloat16),
        v_pages=jnp.asarray(_np(ts.v_pages), jnp.bfloat16))
    args = (np.array([0, 5], np.int32), pt, np.array([0, 12], np.int32),
            np.array([False, True]))
    jlog, _ = JG.paged_decode_step(jcfg, jp, js, *map(jnp.asarray, args))
    tlog = G.paged_decode_step(cfg, tp, ts, *map(torch.as_tensor, args))
    np.testing.assert_allclose(tlog[1].numpy(), np.asarray(jlog[1]),
                               **TOL_STEP)


def test_paged_decode_logits_close_to_ring_decode(models):
    """The reference's model-level differential, in the port: paged
    window decode against the dense ring cache, the same greedy tokens
    and close logits through ring wraps (page 4, window 8, R 3)."""
    jcfg, jp, cfg, tp = models
    page = 4
    R = G.ring_rows(cfg.recurrent.window, page)
    plen, gen = 8, 10
    toks = torch.as_tensor(_tokens(1, (1, plen)))
    logits_d, st = G.prefill(cfg, tp, {"tokens": toks}, plen + gen)
    ps = G.init_paged_decode_state(cfg, 1, 8, page, device="cpu")
    last, kv, conv, h = G.paged_prefill(cfg, tp, {"tokens": toks},
                                        torch.tensor([plen]))
    n_lo = max(0, plen - cfg.recurrent.window) // page
    n_hi = (plen - 1) // page
    pages = list(range(1, 2 + n_hi - n_lo))
    pids = torch.zeros((plen // page,), dtype=torch.int32)
    for i, pg in enumerate(pages):
        pids[n_lo + i] = pg
    G.write_prefill_state(cfg, ps, (kv[0][:, 0], kv[1][:, 0]), conv, h,
                          pids, 0)
    np.testing.assert_allclose(last.numpy(), logits_d.numpy(), **TOL32)
    pt = torch.zeros((1, 4), dtype=torch.int32)
    for i, pg in zip(range(n_lo, n_hi + 1), pages):
        pt[0, i % R] = pg
    free = iter(range(2 + n_hi - n_lo, 8))
    tok_d = tok_p = logits_d.argmax(-1)
    live = plen
    for i in range(gen):
        if live % page == 0:            # engine-side ring growth
            pt[0, (live // page) % R] = next(free)
        lg_d, st = G.decode_step(cfg, tp, st, tok_d)
        lg_p = G.paged_decode_step(cfg, tp, ps, tok_p, pt,
                                   torch.tensor([live], dtype=torch.int32),
                                   torch.tensor([True]))
        tok_d, tok_p = lg_d.argmax(-1), lg_p.argmax(-1)
        assert int(tok_d[0]) == int(tok_p[0]), f"diverged at step {i}"
        np.testing.assert_allclose(lg_d.numpy(), lg_p.numpy(), rtol=0.05,
                                   atol=0.05)
        live += 1


# --- the engine's hybrid backend ---------------------------------------------------------


def test_engine_backend_is_the_hybrid_ring(models):
    jcfg, jp, cfg, tp = models
    assert engine_backend(cfg) is HybridBackend
    be = HybridBackend(cfg, tp, EngineConfig(**ECFG))
    assert be.paged and be.ring_rows == G.ring_rows(8, 8) == 2
    assert be.page_bytes == 2 * 1 * 8 * 1 * 16 * 2      # K+V, 1 attn layer
    # conv (2 rec, 2 slots, 3, 64) bf16 + h (2, 2, 64) f32
    assert be.slot_state_bytes == 2 * 2 * 3 * 64 * 2 + 2 * 2 * 64 * 4
    pgr = EngineConfig(**ECFG).pager
    assert be.admission_rows(pgr, 20) == [n % 2 for n in range(1, 3)]
    assert be.can_ever_fit(pgr, 10_000, 10_000, 10_000)
    for other in ("codeqwen1.5-7b", "rwkv6-7b", "deepseek-v2-lite-16b"):
        assert engine_backend(get_config(other).reduced()).ring_rows is None


def test_infeasible_ring_geometry_raises_as_the_reference(models):
    """A ring longer than the table row or the pool raises at
    construction, with the reference's message."""
    jcfg, jp, cfg, tp = models
    bad = dict(ECFG, page_size=4, max_pages_per_seq=2, prefill_bucket=4)
    with pytest.raises(ValueError) as mine:
        HybridBackend(cfg, tp, EngineConfig(**bad))
    with pytest.raises(ValueError) as ref:
        JEngine(jcfg, jp, JEngineConfig(**bad))
    assert str(mine.value) == str(ref.value)


def test_growth_row_frees_the_page_that_left_the_window():
    """Linear backends grow into row pi; the ring wraps into pi % R and
    frees the page already there first."""
    alloc = PageAllocator(9)
    pages = alloc.alloc(7, 3)
    table = np.zeros((1, 3), np.int32)
    table[0, :] = pages

    class Ring:
        ring_rows = 3
    assert E._growth_row(type("Lin", (), {"ring_rows": None}), alloc, table,
                         0, 5, 7) == 5
    assert E._growth_row(Ring, alloc, table, 0, 4, 7) == 1
    assert table[0, 1] == 0 and alloc.live_count == 2
    assert E._growth_row(Ring, alloc, table, 0, 7, 7) == 1   # already trash
    assert alloc.live_count == 2
    alloc.free_owner(7)
    alloc.check()


def test_paged_backend_matches_static_oracle(models):
    """test_engine_families.py:55: the engine's window-ring decode
    reproduces the static path's greedy trajectory token for token, with
    the reference engine's ledger."""
    jcfg, jp, cfg, tp = models
    prompt = _tokens(7, (6,))
    want = _static_oracle(cfg, tp, prompt, 8)
    rep = run_port(cfg, tp, [Request(rid=0, prompt=prompt.copy(),
                                     max_new_tokens=8)], **ECFG)
    (req,) = rep.completed
    assert not req.truncated and req.generated == want
    assert rep.page_bytes > 0            # really paged, not static
    jrep = JEngine(jcfg, jp, JEngineConfig(**ECFG)).run(
        [JRequest(rid=0, prompt=prompt.copy(), max_new_tokens=8)])
    assert ledger(rep) == ledger(jrep)


def test_window_eviction_prompt_longer_than_window(models):
    """test_engine_families.py:69: a 20-token prompt past the window (8)
    in a 4-page pool smaller than its naive demand: admission maps only
    the in-window pages, decode matches the oracle across ring wraps, the
    slot never holds more than ring_rows pages, nothing is preempted, and
    the ledger is the reference's."""
    jcfg, jp, cfg, tp = models
    win = cfg.recurrent.window
    prompt = _tokens(9, (win + 12,))
    want = _static_oracle(cfg, tp, prompt, 10)
    tiny = dict(num_slots=1, page_size=8, num_pages=4, max_pages_per_seq=4,
                prefill_bucket=8)
    rep = run_port(cfg, tp, [Request(rid=0, prompt=prompt.copy(),
                                     max_new_tokens=10)], **tiny)
    (req,) = rep.completed
    assert not req.truncated and req.generated == want
    assert rep.peak_live_pages <= G.ring_rows(win, 8)
    assert rep.preemptions == 0
    jrep = JEngine(jcfg, jp, JEngineConfig(**tiny)).run(
        [JRequest(rid=0, prompt=prompt.copy(), max_new_tokens=10)])
    assert ledger(rep) == ledger(jrep)
    assert jrep.completed[0].generated == req.generated


@pytest.mark.parametrize("horizon", [1, 16])
def test_engine_matches_reference_with_arrivals(models, horizon):
    """test_horizon.py:56 and test_engine_families.py:140: a Poisson trace
    whose arrivals land mid-horizon, per step and fused: the reference's
    ledger, tokens equal or greedy-consistent, every request at its
    budget."""
    _, trep = assert_engines_agree("poisson_trace", TRACE, models=models,
                                   horizon=horizon, **ECFG)
    assert len(trep.completed) == 6
    assert all(len(r.generated) == r.max_new_tokens and not r.truncated
               for r in trep.completed)


def test_fused_matches_per_step_and_solo_runs(models):
    """Fused (horizon 16) against per-step on the same trace: the same
    tokens and admission/finish steps, fewer dispatches and syncs; and
    interleaving leaks nothing across slots: each request equals its solo
    run."""
    _, _, cfg, tp = models
    _, trace = traces("poisson_trace", vocab_size=cfg.vocab_size, **TRACE)
    rf = run_port(cfg, tp, trace, horizon=16, **ECFG)
    rs = run_port(cfg, tp, trace, horizon=1, **ECFG)
    assert {r.rid: r.generated for r in rf.completed} == \
        {r.rid: r.generated for r in rs.completed}
    assert {r.rid: (r.admitted_step, r.done_step) for r in rf.completed} == \
        {r.rid: (r.admitted_step, r.done_step) for r in rs.completed}
    assert rf.device_dispatches < rs.device_dispatches
    assert rf.host_syncs < rs.host_syncs
    by_rid = {r.rid: r.generated for r in rf.completed}
    for r in trace[:3]:
        solo = run_port(cfg, tp, [Request(rid=r.rid, prompt=r.prompt.copy(),
                                          max_new_tokens=r.max_new_tokens)],
                        **ECFG)
        assert solo.completed[0].generated == by_rid[r.rid], r.rid


def test_ring_wrap_clamps_inside_horizon(models):
    """test_horizon.py:73: generation far past the window wraps the ring
    many times; every wrap recycles a row on the host, so a horizon of 32
    clamps at the wrap, and tokens and steps equal the per-step run's and
    the reference's."""
    jcfg, jp, cfg, tp = models
    prompt = _tokens(9, (6,))
    trace = [Request(rid=0, prompt=prompt.copy(), max_new_tokens=30)]
    rf = run_port(cfg, tp, trace, horizon=32, **ECFG)
    rs = run_port(cfg, tp, trace, horizon=1, **ECFG)
    assert rf.completed[0].generated == rs.completed[0].generated
    assert rf.decode_steps == rs.decode_steps
    assert rf.peak_live_pages <= G.ring_rows(8, 8)
    jrep = JEngine(jcfg, jp, JEngineConfig(horizon=32, **ECFG)).run(
        [JRequest(rid=0, prompt=prompt.copy(), max_new_tokens=30)])
    assert ledger(rf) == ledger(jrep)


def test_graph_runner_body_matches_the_eager_horizon(models):
    """The CUDA-graph runner's step body (run eagerly on the CPU through
    its static buffers) against ``paged_decode_multi`` from the same ring
    state: the same tokens, loop tensors and state."""
    _, _, cfg, tp = models
    B, page, M = 2, 8, 4
    gen = torch.Generator().manual_seed(5)

    def backend():
        return HybridBackend(cfg, tp, EngineConfig(
            num_slots=B, page_size=page, num_pages=1 + B * M,
            max_pages_per_seq=M, prefill_bucket=8, horizon=6))

    a, b = backend(), backend()
    for ta, tb in zip((a.state.conv, a.state.h, a.state.k_pages,
                       a.state.v_pages), (b.state.conv, b.state.h,
                                          b.state.k_pages, b.state.v_pages)):
        ta.copy_(torch.randn(ta.shape, generator=gen))
        tb.copy_(ta)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32).view(B, M)
    table[:, 2:] = 0            # ring of 2 rows, the rest trash
    start = dict(pending=torch.tensor([3, 9], dtype=torch.int32),
                 lengths=torch.tensor([13, 5], dtype=torch.int32),
                 remaining=torch.tensor([3, 6], dtype=torch.int32))
    mask = torch.tensor([True, True])
    ta = {k: v.clone() for k, v in start.items()}
    tb = {k: v.clone() for k, v in start.items()}
    out_a = a.decode_eager(ta["pending"], ta["lengths"], ta["remaining"],
                           table, mask, 3)
    graph = DecodeGraph(b.decode_step, B, M, 6, "cpu")
    out_b = graph.run(tb["pending"], tb["lengths"], tb["remaining"], table,
                      mask, 3)
    assert torch.equal(out_a, out_b)
    for k in start:
        assert torch.equal(ta[k], tb[k]), k
    for f in ("conv", "h", "k_pages", "v_pages"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# --- the static path and the entry point ------------------------------------------


def test_run_static_ledger_matches_reference(models):
    """run_static: the reference's ledger (cache bytes: the state's
    leaves) and tokens equal or greedy-consistent against the reference's
    static path teacher-forced with the port's tokens."""
    jcfg, jp, cfg, tp = models
    kw = dict(TRACE, vocab_size=cfg.vocab_size)
    jrep = jrun_static(jcfg, jp, jsched.poisson_trace(**kw), num_slots=2)
    trep = run_static(cfg, tp, tsched.poisson_trace(**kw), num_slots=2)
    for f in ("prefill_calls", "decode_steps", "slot_steps",
              "useful_slot_steps", "prefill_tokens", "cache_bytes_alloc",
              "new_tokens"):
        assert getattr(trep, f) == getattr(jrep, f), f
    jtok = {r.rid: r.generated for r in jrep.completed}
    for i in range(0, 5, 2):
        group = trep.completed[i:i + 2]
        if any(r.generated != jtok[r.rid] for r in group):
            assert static_teacher_gap(jcfg, jp, group) <= GREEDY_GAP


@pytest.mark.parametrize("mode", ["auto", "engine", "static"])
def test_serve_hybrid_on_the_cpu(mode, capsys):
    """``launch.serve --arch recurrentgemma-9b`` on the CPU in every mode;
    ``auto`` takes the engine (the hybrid backend), as the reference
    does."""
    assert serve.main(["--arch", ARCH, "--mode", mode, "--device", "cpu",
                       "--greedy", "--batch", "2", "--requests", "3",
                       "--prompt-len", "12", "--gen", "6"]) == 0
    out = capsys.readouterr().out
    want = "static" if mode == "static" else "engine"
    assert f"arch={ARCH}-smoke mode={want}" in out
    assert out.rstrip().endswith("ok")


def test_model_registry_serves_the_hybrid_family():
    api = get_model(get_config(ARCH).reduced())
    assert api.init_decode_state is G.init_decode_state
    assert api.loss_fn is G.loss_fn
    assert api.prefill is G.prefill and api.decode_step is G.decode_step
    assert api.init_params is G.init_params and api.forward is G.forward


def test_engine_run_frees_every_ring_page(models):
    """A mixed trace through a pool that holds only two rings: every
    request completes untruncated, pages wrap and are freed, and the
    allocator ends empty (the engine asserts no leak)."""
    _, _, cfg, tp = models
    trace = [Request(rid=i, prompt=_tokens(20 + i, (4 + 7 * i,)),
                     max_new_tokens=14 + 5 * i, arrival=i)
             for i in range(4)]
    rep = run_port(cfg, tp, copy.deepcopy(trace), num_slots=2, page_size=8,
                   num_pages=5, max_pages_per_seq=2, prefill_bucket=8)
    assert all(not r.truncated and len(r.generated) == r.max_new_tokens
               for r in rep.completed)
    assert rep.peak_live_pages <= 4
