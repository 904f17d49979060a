"""The port's static-only families against the JAX package: olmoe-1b-7b
(GQA-MoE, through ``models.moe``) and whisper-tiny (encoder-decoder,
``models.whisper``), reduced, on converted weights; their configs, the
static serving path (``run_static``) and its entry point.

Inputs come from numpy seeds. Tolerances: model logits and caches run in
bf16 compute like the reference, which rounds at other places in XLA
than PyTorch does (and rounds attention weights to bf16 where the port's
plain attention, its CPU path, keeps them in f32): rtol = atol = 4e-2, a few
bf16 quanta of logits of order 1-4 (tests/test_torch_models.py). Routing
near a tie follows bf16 rounding, where the reference's compiled run and
its op-by-op run (``jax.disable_jit``) can disagree; olmoe is held
against both (``close_to_reference``). ``run_static`` ledgers must be
equal; tokens equal or, where they differ, greedy-consistent (the
repository's greedy gap, 0.0625) against the reference's own static path
teacher-forced with the port's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (GREEDY_GAP, both_runs, close_to_reference,
                           static_teacher_gap)
from repro.configs import get_config as jget
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.runtime import run_static as jrun_static
from repro.runtime import scheduler as jsched
from repro.runtime.engine import engine_backend as jengine_backend
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import _FAMILIES, get_model
from repro_torch.models import layers as L
from repro_torch.runtime import (Engine, EngineConfig, Request,
                                 encdec_extras_fn, engine_backend,
                                 run_static)
from repro_torch.runtime import scheduler as tsched

TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
ARCHS = ["olmoe-1b-7b", "whisper-tiny"]
LEDGER = ("prefill_calls", "decode_steps", "slot_steps", "useful_slot_steps",
          "prefill_tokens", "cache_bytes_alloc", "new_tokens")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _batch(cfg, rng, B, S):
    """The same seeded batch for both packages: tokens, and frames for
    the encoder-decoder."""
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    if cfg.family == "encdec":
        fr = rng.standard_normal((B, cfg.encoder.seq_len, cfg.d_model)
                                 ).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.tensor(fr)
    return jb, tb


def _np(t):
    return t.float().numpy()


# --- configs (fault: reduced() kept whisper's full encoder) ----------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_reduced_matches_reference(arch):
    """Full and reduced configs name the reference's shapes, the encoder
    tower included (reduced whisper: 2 encoder layers of 16 frames)."""
    for j, t in ((jget(arch), get_config(arch)),
                 (jget(arch).reduced(), get_config(arch).reduced())):
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
                  "use_bias", "qkv_bias", "tie_embeddings", "rope_theta",
                  "q_dim", "kv_dim"):
            assert getattr(j, f) == getattr(t, f), f
        for f in ("moe", "mla", "recurrent", "encoder"):
            a, b = getattr(j, f), getattr(t, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f
    if arch == "whisper-tiny":
        assert get_config(arch).reduced().encoder.seq_len == 16


# --- layers ------------------------------------------------------------------------


def test_gelu_mlp_matches_jax():
    """tanh-approximate GELU between two biased products, in f32."""
    rng = np.random.default_rng(0)
    a = [rng.standard_normal(s).astype(np.float32)
         for s in ((2, 5, 32), (32, 48), (48,), (48, 32), (32,))]
    np.testing.assert_allclose(
        L.gelu_mlp(*(torch.tensor(x) for x in a)).numpy(),
        np.asarray(JL.gelu_mlp(*(jnp.asarray(x) for x in a))),
        rtol=1e-4, atol=1e-3)      # f32 sums over 32 and 48 terms


# --- the models on converted weights ---------------------------------------------


def test_init_params_shapes_and_dtypes_match_converted(models):
    """init_params draws the reference's tree: every name and shape, with
    the converter's dtypes (layernorm scales and biases in f32)."""
    jcfg, jp, cfg, tp = models
    mine = get_model(cfg).init_params(cfg, seed=0, device="cpu")

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + k + ".")
                continue
            assert tuple(a[k].shape) == tuple(b[k].shape), path + k
            assert a[k].dtype == b[k].dtype, path + k

    walk(mine, tp)
    if cfg.family == "encdec":
        for name in ("enc_ln", "enc_lnb", "dec_ln", "dec_lnb"):
            assert tp[name].dtype == torch.float32, name
        for name in ("ln1b", "ln_x", "ln_xb", "ln2b"):
            assert tp["dec_blocks"][name].dtype == torch.float32, name
        assert tp["dec_blocks"]["x_bv"].dtype == torch.bfloat16
    else:
        assert tp["blocks"]["wk"].dtype == torch.bfloat16
        assert tp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16


def test_forward_prefill_and_decode_match_reference(models):
    """Logits of the full forward, the static prefill and three decode
    steps against the reference's compiled and op-by-op runs; the cache
    after prefill; greedy tokens equal."""
    jcfg, jp, cfg, tp = models
    jm, tm = jget_model(jcfg), get_model(cfg)
    jb, tb = _batch(cfg, np.random.default_rng(4), 2, 12)
    want, eager = both_runs(jm.forward, jcfg, jp, jb)
    got = tm.forward(cfg, tp, tb)
    close_to_reference(got.numpy(), want, eager)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(eager).argmax(-1))

    (jl, _), (el, es) = both_runs(jm.prefill, jcfg, jp, jb, 16)
    tl, ts = tm.prefill(cfg, tp, tb, 16)
    close_to_reference(tl.numpy(), jl, el)
    if cfg.family == "encdec":
        np.testing.assert_allclose(_np(ts.k), np.asarray(es.k, np.float32),
                                   **TOL_BF16)
        np.testing.assert_allclose(_np(ts.enc_out),
                                   np.asarray(es.enc_out, np.float32),
                                   **TOL_BF16)
    else:
        assert ts.kv.shape == es.kv.shape == (2, 2, 2, 16, 2, 16)
        np.testing.assert_allclose(_np(ts.kv), np.asarray(es.kv, np.float32),
                                   **TOL_BF16)
    tok = np.asarray(el).argmax(-1).astype(np.int32)
    for _ in range(3):
        (jl, _), (el, es) = both_runs(jm.decode_step, jcfg, jp, es,
                                  jnp.asarray(tok))
        tl, ts = tm.decode_step(cfg, tp, ts, torch.tensor(tok))
        close_to_reference(tl.numpy(), jl, el)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(el).argmax(-1))
        tok = np.asarray(el).argmax(-1).astype(np.int32)
    assert ts.pos == int(es.pos) == 15


# --- run_static (fault: extras were dropped) --------------------------------------


def test_run_static_ledger_matches_reference(models):
    """One seeded trace (whisper's requests carry their frames as extras)
    through both packages' run_static: the same ledger, cache bytes
    included (the state's tensors plus the int32 position), the same
    schedule, and tokens equal or greedy-consistent."""
    jcfg, jp, cfg, tp = models
    extras_fn = encdec_extras_fn(cfg) if cfg.family == "encdec" else None
    kw = dict(n_requests=5, mean_interarrival=0.5, prompt_lens=(6, 10),
              gen_lens=(3, 6), vocab_size=cfg.vocab_size, seed=4,
              extras_fn=extras_fn)
    jtrace, ttrace = jsched.poisson_trace(**kw), tsched.poisson_trace(**kw)
    jrep = jrun_static(jcfg, jp, jtrace, num_slots=2)
    trep = run_static(cfg, tp, ttrace, num_slots=2)
    for f in LEDGER:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert sorted((r.rid, r.admitted_step, r.done_step)
                  for r in trep.completed) == \
        sorted((r.rid, r.admitted_step, r.done_step) for r in jrep.completed)
    jtok = {r.rid: r.generated for r in jrep.completed}
    groups = [trep.completed[i:i + 2] for i in range(0, 5, 2)]
    for group in groups:
        if all(r.generated == jtok[r.rid] for r in group):
            continue
        assert static_teacher_gap(jcfg, jp, group) <= GREEDY_GAP


def test_run_static_refuses_a_group_with_mixed_extras():
    """A lockstep group must carry the same extras throughout, as the
    reference asserts."""
    cfg = get_config("whisper-tiny").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32) + i,
                    max_new_tokens=2, arrival=0,
                    extras=encdec_extras_fn(cfg)(rng) if i else None)
            for i in range(2)]
    with pytest.raises(ValueError, match="lack extras"):
        run_static(cfg, params, reqs, num_slots=2)


def test_static_families_have_no_engine_backend():
    """As in the reference: olmoe (GQA-MoE) and whisper (encoder-decoder)
    serve only through the static path; the Engine refuses them."""
    ecfg = EngineConfig(num_slots=2, page_size=8, num_pages=17,
                        max_pages_per_seq=8, prefill_bucket=8)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        assert engine_backend(cfg) is None
        params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="no engine backend"):
            Engine(cfg, params, ecfg)


@pytest.mark.parametrize("arch,mode", [("olmoe-1b-7b", "static"),
                                       ("whisper-tiny", "static"),
                                       ("codeqwen1.5-7b", "engine")])
def test_serve_default_mode_auto_picks_engine_or_static(arch, mode, capsys):
    """``launch.serve`` without ``--mode`` is ``--mode auto``, as in the
    reference: the engine where the reduced config has a backend, the
    static path otherwise."""
    assert serve.main(["--arch", arch, "--device", "cpu", "--greedy",
                       "--batch", "2", "--requests", "3", "--prompt-len",
                       "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke mode={mode}" in out
    assert out.rstrip().endswith("ok")


SERVED = sorted(a for a in REGISTRY if get_config(a).family in _FAMILIES)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("reduced", [True, False])
def test_auto_mode_choice_equals_the_reference(arch, reduced):
    """For every arch both packages serve, ``auto`` picks the engine
    exactly where the reference's ``engine_backend`` finds a backend."""
    cfg, jcfg = get_config(arch), jget(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert (engine_backend(cfg) is None) == (jengine_backend(jcfg) is None)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_static_entry_point_on_the_cpu(arch, capsys):
    """``launch.serve --mode static`` serves both reduced archs on the
    CPU; whisper's frames come from the trace's rng."""
    assert serve.main(["--arch", arch, "--mode", "static", "--device",
                       "cpu", "--greedy", "--batch", "2", "--requests", "3",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke mode=static" in out and "ok" in out


def test_encdec_extras_draw_from_the_trace_rng():
    """The extras hook draws (T_enc, d_model) f32 frames from the trace's
    rng, so both packages' generators give the same trace."""
    cfg = get_config("whisper-tiny").reduced()
    kw = dict(n_requests=3, mean_interarrival=1.0, prompt_lens=(4, 6),
              gen_lens=(2,), vocab_size=cfg.vocab_size, seed=7,
              extras_fn=encdec_extras_fn(cfg))
    for a, b in zip(jsched.poisson_trace(**kw), tsched.poisson_trace(**kw)):
        assert a.arrival == b.arrival and np.array_equal(a.prompt, b.prompt)
        assert b.extras["frames"].shape == (16, 64)
        assert b.extras["frames"].dtype == np.float32
        np.testing.assert_array_equal(a.extras["frames"], b.extras["frames"])
    trace = tsched.poisson_trace(**kw)
    assert not np.array_equal(trace[0].extras["frames"],
                              trace[1].extras["frames"])
