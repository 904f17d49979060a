"""rwkv6-7b (the ssm family) in the port against the JAX package: its
config and parameters, the two WKV routines, prefill and decode with the
bf16 state, the fused decode, the engine's non-paged path (the recurrent
backend, per-step and fused, arrivals landing mid-horizon), slot reuse,
the static path and the serving entry point. Reduced config, converted
weights, inputs from numpy seeds.

Tolerances: the WKV routines in f32 within tests/test_kernels.py's f32
TOL (rtol 1e-4, atol 2e-4). Logits and the state run in bf16 compute,
which the reference rounds at other places in XLA than PyTorch does
(its compiled and op-by-op runs already differ by up to 0.023 in logits
of order 3 here): rtol = atol = 4e-2, a few bf16 quanta, as
tests/test_torch_models.py holds the dense family. Engine ledgers must be
equal; tokens equal or, where they differ, greedy-consistent within the
repository's greedy gap (_torch_parity).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (GREEDY_GAP, assert_engines_agree, run_port, setup,
                           static_teacher_gap, traces)
from repro.configs import get_config as jget
from repro.models import rwkv6 as JR
from repro.runtime import run_static as jrun_static
from repro.runtime import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import rwkv6 as R
from repro_torch.models.transformer import F32_PARAMS
from repro_torch.runtime import Request, run_static
from repro_torch.runtime import scheduler as tsched

ARCH = "rwkv6-7b"
TOL32 = dict(rtol=1e-4, atol=2e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
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


def _state_to_jax(ts) -> JR.RwkvState:
    return JR.RwkvState(
        att_prev=jnp.asarray(_np(ts.att_prev), jnp.bfloat16),
        ffn_prev=jnp.asarray(_np(ts.ffn_prev), jnp.bfloat16),
        wkv=jnp.asarray(_np(ts.wkv), jnp.bfloat16),
        pos=jnp.asarray(ts.pos, jnp.int32))


def _assert_state_close(ts, js):
    for f in ("att_prev", "ffn_prev", "wkv"):
        got = getattr(ts, f)
        assert got.dtype == torch.bfloat16, f       # bf16 between calls
        np.testing.assert_allclose(_np(got), np.asarray(getattr(js, f),
                                                        np.float32),
                                   **TOL_BF16, err_msg=f)
    assert ts.pos == int(js.pos)


# --- config and parameters ----------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    j, t = jget(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
              "use_bias", "tie_embeddings", "mrope"):
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.recurrent) == dataclasses.asdict(t.recurrent)


def test_init_params_tree_and_dtypes_match_converted(models):
    """init_params draws the reference's names and shapes in the
    converter's dtypes: the layernorm scales and biases the converter
    keeps in f32 (``ln1``/``ln2``/``ln1b``/``ln2b``/``ln_f``) in f32, every
    other leaf in bf16."""
    jcfg, jp, cfg, tp = models
    mine = R.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == \
        jax.tree.map(lambda t: tuple(t.shape), mine)
    flat = [*((k, v) for k, v in mine.items() if k != "blocks"),
            *mine["blocks"].items()]
    for name, t in flat:
        want = torch.float32 if name in F32_PARAMS else torch.bfloat16
        assert t.dtype == want, name
        assert t.dtype == (tp["blocks"].get(name, tp.get(name))).dtype, name
    assert mine["blocks"]["ln1"].dtype == torch.float32
    assert mine["blocks"]["gn"].dtype == torch.bfloat16


# --- the WKV routines -----------------------------------------------------------------


def _wkv_inputs(rng, B, S, H, d):
    r, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, d)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, d))).astype(np.float32)
    state = rng.standard_normal((B, H, d, d)).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("S", [1, 7, 32, 40, 64])
def test_wkv_routines_match_reference(S):
    """Both WKV routines in f32 against the reference's at S 1 (scan), 7
    (gcd 1: the chunked routine falls back to the scan), 32 (one chunk),
    40 (gcd 8: five chunks) and 64 (two chunks)."""
    args = _wkv_inputs(np.random.default_rng(S), 2, S, 3, 8)
    targs = [torch.tensor(a) for a in args]
    for jfn, tfn in ((JR._wkv_scan, R._wkv_scan),
                     (JR._wkv_chunked, R._wkv_chunked)):
        jy, js = jfn(*map(jnp.asarray, args))
        ty, ts = tfn(*targs)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL32)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL32)
    if S % 2:                       # gcd(S, 32) == 1: the scan itself
        for a, b in zip(R._wkv_chunked(*targs), R._wkv_scan(*targs)):
            assert torch.equal(a, b)


# --- prefill, decode and the fused decode ---------------------------------------------


@pytest.mark.parametrize("S", [7, 32])
def test_prefill_matches_reference(models, S):
    """Prefill logits and the bf16 state it leaves, at an exact length
    whose chunk is the scan (7) and a whole chunk (32)."""
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, js = JR.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, ts = R.prefill(cfg, tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    _assert_state_close(ts, js)


def test_decode_step_matches_reference_from_one_state(models):
    """Decode steps from the same bf16 state (the port's, handed to the
    reference each step, so rounding does not compound): logits and the
    state after each step; the state is updated in place."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    _, ts = R.prefill(cfg, tp, {"tokens": torch.tensor(toks)})
    wkv = ts.wkv
    for i in range(4):
        tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        jl, js = JR.decode_step(jcfg, jp, _state_to_jax(ts), jnp.asarray(tok))
        tl, ts = R.decode_step(cfg, tp, ts, torch.tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        _assert_state_close(ts, js)
    assert ts.wkv is wkv and ts.pos == 13


@pytest.mark.parametrize("h", [1, 4])
def test_decode_multi_matches_reference_and_feeds_token_0(models, h):
    """A teacher-forced fused horizon from one state: slot 0 live, slot 1
    masked (it consumes token 0 every step, as the reference's per-step
    engine feeds it), slot 2 with a budget of 2. The tokens and the loop
    tensors match the reference; after one step the state does too
    (later steps compound bf16 rounding, and are held step by step by
    the test above); the per-step loop gives the same state bit for
    bit."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    _, ts = R.prefill(cfg, tp, {"tokens": torch.tensor(toks)})
    js = _state_to_jax(ts)
    hmax = 5
    teacher = rng.integers(1, cfg.vocab_size, (hmax, 3)).astype(np.int32)
    loop = dict(pending=np.array([5, 9, 17], np.int32),
                lengths=np.array([6, 6, 6], np.int32),
                remaining=np.array([8, 8, 2], np.int32))
    mask = np.array([True, False, True])
    out_j, js, pj, lj, rj = JR.decode_multi(
        jcfg, jp, js, *(jnp.asarray(a) for a in loop.values()),
        jnp.asarray(mask), jnp.asarray(h), hmax=hmax,
        teacher=jnp.asarray(teacher))
    p_t, l_t, r_t = (torch.tensor(a) for a in loop.values())
    ref_state = R.RwkvState(ts.att_prev.clone(), ts.ffn_prev.clone(),
                            ts.wkv.clone(), ts.pos)
    out_t = R.decode_multi(cfg, tp, ts, p_t, l_t, r_t, torch.tensor(mask),
                           h, hmax=hmax, teacher=torch.tensor(teacher))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    for got, want in ((p_t, pj), (l_t, lj), (r_t, rj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if h == 1:
        _assert_state_close(ts, js)
    # the same horizon as per-step decodes: live slots feed their token,
    # the others token 0
    pending, remaining = loop["pending"].copy(), loop["remaining"].copy()
    for i in range(h):
        live = mask & (remaining > 0)
        R.decode_step(cfg, tp, ref_state,
                      torch.tensor(np.where(live, pending, 0)))
        pending = np.where(live, teacher[i], pending)
        remaining -= live
    for f in ("att_prev", "ffn_prev", "wkv"):
        assert torch.equal(getattr(ts, f), getattr(ref_state, f)), f


# --- the engine's non-paged path --------------------------------------------------------


def _slot_state_bytes(cfg, B):
    L, D, H, dh = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
    return 2 * (2 * L * B * D + L * B * H * dh * dh) + 4   # bf16, int32 pos


@pytest.mark.parametrize("horizon", [1, 16])
def test_engine_matches_jax_engine(models, horizon):
    """Per-step (horizon 1) and fused (16, arrivals landing mid-horizon)
    runs: equal ledgers (slot_state_bytes and kv_bytes_peak included: the
    whole cache is per-slot state), no pages, tokens equal or greedy-
    consistent."""
    cfg = models[2]
    jrep, trep = assert_engines_agree("poisson_trace", TRACE, models=models,
                                      horizon=horizon, **ECFG)
    want = _slot_state_bytes(cfg, ECFG["num_slots"])
    assert trep.slot_state_bytes == jrep.slot_state_bytes == want
    assert trep.kv_bytes_peak == trep.cache_bytes_alloc == want
    assert trep.page_bytes == 0 and trep.peak_live_pages == 0
    assert trep.prefill_tokens == sum(len(r.prompt) for r in trep.completed)
    assert len(trep.completed) == 6
    if horizon > 1:
        assert trep.host_syncs < trep.decode_steps
    else:
        assert trep.host_syncs == trep.decode_steps


def test_fused_matches_per_step_in_the_port(models):
    """Fusion changes how many dispatches the schedule costs, never the
    schedule or the tokens."""
    cfg, tp = models[2:]
    _, trace = traces("poisson_trace", vocab_size=cfg.vocab_size, **TRACE)
    fused = run_port(cfg, tp, trace, horizon=16, **ECFG)
    step = run_port(cfg, tp, trace, horizon=1, **ECFG)
    assert {r.rid: r.generated for r in fused.completed} == \
        {r.rid: r.generated for r in step.completed}
    assert {r.rid: (r.admitted_step, r.done_step) for r in fused.completed} \
        == {r.rid: (r.admitted_step, r.done_step) for r in step.completed}
    assert fused.device_dispatches < step.device_dispatches


@pytest.mark.parametrize("horizon", [1, 16])
def test_readmitted_slot_gives_the_solo_run(models, horizon):
    """Six requests through two slots: every slot is released and
    admitted again, and each request's tokens equal its solo run (the
    prefill overwrites whatever the slot's state held)."""
    cfg, tp = models[2:]
    _, trace = traces("poisson_trace", vocab_size=cfg.vocab_size, **TRACE)
    rep = run_port(cfg, tp, trace, horizon=horizon, **ECFG)
    assert rep.prefill_calls == 6 > ECFG["num_slots"]
    for r in rep.completed:
        solo = run_port(cfg, tp, [Request(rid=r.rid, prompt=r.prompt.copy(),
                                          max_new_tokens=r.max_new_tokens)],
                        horizon=horizon, **ECFG)
        assert solo.completed[0].generated == r.generated, r.rid


# --- the static path and the entry point ------------------------------------------


def test_run_static_ledger_matches_reference(models):
    """run_static: the reference's ledger (cache bytes: the state's
    tensors plus the int32 position) and schedule, tokens equal or
    greedy-consistent against the reference's static path teacher-forced
    with the port's tokens."""
    jcfg, jp, cfg, tp = models
    kw = dict(n_requests=5, mean_interarrival=0.5, prompt_lens=(6, 10),
              gen_lens=(3, 6), vocab_size=cfg.vocab_size, seed=4)
    jrep = jrun_static(jcfg, jp, jsched.poisson_trace(**kw), num_slots=2)
    trep = run_static(cfg, tp, tsched.poisson_trace(**kw), num_slots=2)
    for f in ("prefill_calls", "decode_steps", "slot_steps",
              "useful_slot_steps", "prefill_tokens", "cache_bytes_alloc",
              "new_tokens"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.cache_bytes_alloc == _slot_state_bytes(cfg, 2)
    assert sorted((r.rid, r.admitted_step, r.done_step)
                  for r in trep.completed) == \
        sorted((r.rid, r.admitted_step, r.done_step) for r in jrep.completed)
    jtok = {r.rid: r.generated for r in jrep.completed}
    for i in range(0, 5, 2):
        group = trep.completed[i:i + 2]
        if any(r.generated != jtok[r.rid] for r in group):
            assert static_teacher_gap(jcfg, jp, group) <= GREEDY_GAP


@pytest.mark.parametrize("mode", ["auto", "engine", "static"])
def test_serve_rwkv6_on_the_cpu(mode, capsys):
    """``launch.serve --arch rwkv6-7b`` on the CPU in every mode; ``auto``
    takes the engine (the recurrent backend), as the reference does."""
    assert serve.main(["--arch", ARCH, "--mode", mode, "--device", "cpu",
                       "--greedy", "--batch", "2", "--requests", "3",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    want = "static" if mode == "static" else "engine"
    assert f"arch={ARCH}-smoke mode={want}" in out
    assert out.rstrip().endswith("ok")


def test_model_registry_serves_the_ssm_family():
    api = get_model(get_config(ARCH).reduced())
    assert api.init_decode_state is R.init_decode_state
    assert api.loss_fn is R.loss_fn
    assert api.prefill is R.prefill and api.decode_step is R.decode_step
