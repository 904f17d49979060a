"""qwen2-vl-7b (the vlm family) in the port against the JAX package:
its config, M-RoPE, the backbone's forward, static and paged entries with
patch embeddings, the engine (per-step and fused) on a seeded trace whose
requests carry patches, prefix sharing kept to the dense family, the
static path and the serving entry point. Reduced config, converted
weights, inputs from numpy seeds.

Tolerances: M-RoPE in f32 within tests/test_kernels.py's f32 TOL (rtol
1e-4, atol 2e-4). Logits run in bf16 compute, which the reference rounds
at other places in XLA than PyTorch does (and in its attention weights,
which the port's plain attention keeps in f32): rtol = atol = 4e-2, a few
bf16 quanta of logits of order 1-4, as tests/test_torch_models.py holds
the dense family. Engine ledgers must be equal; tokens equal or, where
they differ, greedy-consistent within the repository's greedy gap
(_torch_parity).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (GREEDY_GAP, assert_engines_agree, ledger,
                           run_port, setup, static_teacher_gap)
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.runtime import Engine as JEngine
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import run_static as jrun_static
from repro.runtime import scheduler as jsched
from repro.runtime import vlm_extras_fn as jvlm_extras_fn
from repro.runtime.engine import engine_backend as jengine_backend
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch import serve
from repro_torch.models import _FAMILIES
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import (EngineConfig, PagedTransformerBackend,
                                 engine_backend, run_static, vlm_extras_fn)
from repro_torch.runtime import scheduler as tsched

ARCH = "qwen2-vl-7b"
TOL32 = dict(rtol=1e-4, atol=2e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
ECFG = dict(num_slots=2, page_size=8, num_pages=33, max_pages_per_seq=8,
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


def _patches(cfg, rng, B, P=4):
    pe = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    return jnp.asarray(pe), torch.tensor(pe)


def _trace_kw(cfg, **kw):
    return dict(n_requests=6, mean_interarrival=0.5, prompt_lens=(6, 10),
                gen_lens=(3, 8, 20), seed=2, extras_fn=vlm_extras_fn(cfg),
                **kw)


# --- config and M-RoPE -------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """Every field the reference's config has for qwen2-vl-7b, M-RoPE and
    the patch stub's encoder included, full and reduced."""
    j, t = jget(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
              "use_bias", "qkv_bias", "tie_embeddings", "rope_theta",
              "mrope", "q_dim", "kv_dim"):
        assert getattr(j, f) == getattr(t, f), f
    assert dataclasses.asdict(j.encoder) == dataclasses.asdict(t.encoder)
    assert t.mrope and t.moe is None and t.recurrent is None


def test_mrope_matches_reference_on_distinct_positions():
    """M-RoPE on (t, h, w) rows that differ (a real image grid), at the
    reduced and the published head size: the general triple, not plain
    RoPE; three equal rows give plain RoPE exactly."""
    rng = np.random.default_rng(0)
    assert L.mrope_sections(128) == JL.mrope_sections(128) == (16, 24, 24)
    for dh in (16, 128):
        assert L.mrope_sections(dh) == JL.mrope_sections(dh)
        x = rng.standard_normal((2, 5, 3, dh)).astype(np.float32)
        pos3 = rng.integers(0, 900, (3, 2, 5)).astype(np.int32)
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
        got = L.apply_mrope(torch.tensor(x), torch.tensor(pos3), 1e6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
        plain = L.apply_rope(torch.tensor(x), torch.tensor(pos3[0]), 1e6)
        assert not np.allclose(got.numpy(), plain.numpy(), **TOL32)
        same = L.apply_mrope(torch.tensor(x), torch.tensor(
            np.broadcast_to(pos3[:1], pos3.shape).copy()), 1e6)
        assert torch.equal(same, plain)


# --- the backbone with patch embeddings --------------------------------------------


def test_init_params_and_convert_carry_patch_proj(models):
    """init_params draws the reference's tree, patch_proj included;
    convert carries patch_proj as it is (bf16 of the reference's f32)."""
    jcfg, jp, cfg, tp = models
    mine = T.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == \
        jax.tree.map(lambda t: tuple(t.shape), mine)
    assert mine["patch_proj"].dtype == tp["patch_proj"].dtype == \
        torch.bfloat16
    want = torch.tensor(np.asarray(jp["patch_proj"])).to(torch.bfloat16)
    assert torch.equal(tp["patch_proj"], want)


def test_forward_with_patches_and_pos3_matches_reference(models):
    """The full forward with patch embeddings and distinct M-RoPE rows;
    the patches move the logits (the injection is not a no-op)."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jpe, tpe = _patches(cfg, rng, 2)
    pos3 = rng.integers(0, 40, (3, 2, 9)).astype(np.int32)
    want = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                 "patch_embeds": jpe,
                                 "pos3": jnp.asarray(pos3)})
    got = T.forward(cfg, tp, {"tokens": torch.tensor(toks),
                              "patch_embeds": tpe,
                              "pos3": torch.tensor(pos3)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_BF16)
    bare = T.forward(cfg, tp, {"tokens": torch.tensor(toks),
                               "pos3": torch.tensor(pos3)})
    assert (bare - got).abs().max() > 0.1


def test_static_prefill_and_decode_with_patches_match_reference(models):
    """The static prefill (patches in the batch) and three decode steps:
    logits, the cache after prefill, greedy tokens."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jpe, tpe = _patches(cfg, rng, 2)
    jl, js = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                   "patch_embeds": jpe}, 12)
    tl, ts = T.prefill(cfg, tp, {"tokens": torch.tensor(toks),
                                 "patch_embeds": tpe}, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    np.testing.assert_allclose(ts.k.float().numpy(),
                               np.asarray(js.k, np.float32), **TOL_BF16)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, js = JT.decode_step(jcfg, jp, js, jnp.asarray(tok))
        tl, ts = T.decode_step(cfg, tp, ts, torch.tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ts.pos == int(js.pos) == 10


def test_paged_prefill_and_decode_step_with_patches_match_reference(models):
    """paged_prefill of a bucket-padded prompt with patches, its K/V
    scattered into pages, then paged decode steps at per-slot lengths."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(3)
    plen, page = 7, 4
    toks = np.zeros((1, 8), np.int32)
    toks[0, :plen] = rng.integers(0, cfg.vocab_size, plen)
    jpe, tpe = _patches(cfg, rng, 1)
    lens = np.array([plen], np.int32)
    jl, (jk, jv) = JT.paged_prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                               "patch_embeds": jpe},
                                    jnp.asarray(lens))
    tl, (tk, tv) = T.paged_prefill(cfg, tp, {"tokens": torch.tensor(toks),
                                             "patch_embeds": tpe},
                                   torch.tensor(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    pids = np.array([3, 5], np.int32)
    js = JT.write_prefill_pages(
        jcfg, JT.init_paged_decode_state(jcfg, 9, page),
        (jk[:, 0], jv[:, 0]), jnp.asarray(pids))
    ts = T.init_paged_decode_state(cfg, 9, page, device="cpu")
    T.write_prefill_pages(cfg, ts, (tk[:, 0], tv[:, 0]), torch.tensor(pids))
    pt = np.array([[3, 5, 7, 0]], np.int32)
    tok = int(np.asarray(jl).argmax())
    for i in range(4):
        args = (np.array([tok], np.int32), pt, np.array([plen + i], np.int32),
                np.array([True]))
        jl, js = JT.paged_decode_step(jcfg, jp, js, *map(jnp.asarray, args))
        tl = T.paged_decode_step(cfg, tp, ts, *map(torch.tensor, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        assert int(tl.argmax()) == int(jnp.argmax(jl)), f"step {i}"
        tok = int(jnp.argmax(jl))
    np.testing.assert_allclose(ts.k_pages.float().numpy(),
                               np.asarray(js.k_pages, np.float32),
                               **TOL_BF16)


# --- the engine --------------------------------------------------------------------


def test_vlm_extras_draw_from_the_trace_rng():
    """Both packages' hooks draw the same (4, d_model) f32 patches from
    the trace's rng."""
    cfg = get_config(ARCH).reduced()
    kw = dict(n_requests=3, mean_interarrival=1.0, prompt_lens=(6, 8),
              gen_lens=(2,), vocab_size=cfg.vocab_size, seed=7)
    for a, b in zip(jsched.poisson_trace(**kw,
                                         extras_fn=jvlm_extras_fn(cfg)),
                    tsched.poisson_trace(**kw, extras_fn=vlm_extras_fn(cfg))):
        assert b.extras["patch_embeds"].shape == (4, 64)
        assert b.extras["patch_embeds"].dtype == np.float32
        np.testing.assert_array_equal(a.extras["patch_embeds"],
                                      b.extras["patch_embeds"])
        assert np.array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("horizon", [1, 16])
def test_engine_matches_jax_engine_with_patches(models, horizon):
    """Per-step (horizon 1) and fused (16, arrivals landing mid-horizon)
    runs of a trace whose requests carry patches: ledgers equal, tokens
    equal or greedy-consistent against the forward with the patches."""
    cfg = models[2]
    _, trep = assert_engines_agree("poisson_trace", _trace_kw(cfg),
                                   models=models, horizon=horizon, **ECFG)
    assert trep.page_bytes > 0 and trep.slot_state_bytes == 0
    assert len(trep.completed) == 6 and trep.shared_page_hits == 0
    if horizon > 1:
        assert trep.host_syncs < trep.decode_steps


def _shared_trace(cfg, package):
    """A shared-prefix trace with verbatim re-sends, each request carrying
    its own patches (drawn the same way for both packages)."""
    trace = package.shared_prefix_trace(
        12, overlap=0.5, prompt_len=24, mean_interarrival=0.25,
        gen_lens=(16,), vocab_size=cfg.vocab_size, seed=11, resend_frac=0.5)
    draw, rng = vlm_extras_fn(cfg), np.random.default_rng(3)
    for r in trace:
        r.extras = draw(rng)
    return trace


def test_prefix_sharing_stays_with_the_dense_family(models):
    """The repaired fault: prefix sharing is per backend instance, dense
    only. With sharing on, a vlm engine maps no shared page (same token
    ids, different patches: not the same KV) and matches the JAX engine,
    while the dense engine on the same token trace still shares."""
    jcfg, jp, cfg, tp = models
    sharing = dict(ECFG, num_slots=4, num_pages=41, max_pages_per_seq=8,
                   prefix_sharing=True)
    assert PagedTransformerBackend(cfg, tp, EngineConfig(**sharing)) \
        .prefix_sharing is False
    jrep = JEngine(jcfg, jp, JEngineConfig(**sharing)).run(
        _shared_trace(cfg, jsched))
    trep = run_port(cfg, tp, _shared_trace(cfg, tsched), **sharing)
    assert ledger(trep) == ledger(jrep)
    assert trep.shared_page_hits == 0 and trep.cow_copies == 0
    plain = run_port(cfg, tp, _shared_trace(cfg, tsched),
                     **dict(sharing, prefix_sharing=False))
    assert {r.rid: r.generated for r in trep.completed} == \
        {r.rid: r.generated for r in plain.completed}

    dcfg, dp = setup("codeqwen1.5-7b")[2:]
    assert PagedTransformerBackend(dcfg, dp, EngineConfig(**sharing)) \
        .prefix_sharing is True
    drep = run_port(dcfg, dp, _shared_trace(cfg, tsched), **sharing)
    assert drep.shared_page_hits > 0


# --- the static path and the entry point ------------------------------------------


def test_run_static_ledger_matches_reference(models):
    """run_static on a trace with patches (stacked into each lockstep
    batch): the reference's ledger and schedule, tokens equal or greedy-
    consistent against the reference's static path teacher-forced with
    the port's tokens."""
    jcfg, jp, cfg, tp = models
    kw = dict(n_requests=5, mean_interarrival=0.5, prompt_lens=(6, 10),
              gen_lens=(3, 6), vocab_size=cfg.vocab_size, seed=4,
              extras_fn=vlm_extras_fn(cfg))
    jrep = jrun_static(jcfg, jp, jsched.poisson_trace(**kw), num_slots=2)
    trep = run_static(cfg, tp, tsched.poisson_trace(**kw), num_slots=2)
    for f in ("prefill_calls", "decode_steps", "slot_steps",
              "useful_slot_steps", "prefill_tokens", "cache_bytes_alloc",
              "new_tokens"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert sorted((r.rid, r.admitted_step, r.done_step)
                  for r in trep.completed) == \
        sorted((r.rid, r.admitted_step, r.done_step) for r in jrep.completed)
    jtok = {r.rid: r.generated for r in jrep.completed}
    for i in range(0, 5, 2):
        group = trep.completed[i:i + 2]
        if any(r.generated != jtok[r.rid] for r in group):
            assert static_teacher_gap(jcfg, jp, group) <= GREEDY_GAP


@pytest.mark.parametrize("mode", ["auto", "static"])
def test_serve_qwen2_vl_on_the_cpu(mode, capsys):
    """``launch.serve --arch qwen2-vl-7b`` on the CPU: ``auto`` takes the
    engine, as the reference's ``engine_backend`` does for the vlm
    family; ``static`` serves the same trace in lockstep."""
    assert serve.main(["--arch", ARCH, "--mode", mode, "--device", "cpu",
                       "--greedy", "--batch", "2", "--requests", "3",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    want = "engine" if mode == "auto" else "static"
    assert f"arch={ARCH}-smoke mode={want}" in out
    assert out.rstrip().endswith("ok")


SERVED = sorted(a for a in REGISTRY if get_config(a).family in _FAMILIES)


@pytest.mark.parametrize("reduced", [True, False])
def test_engine_backend_class_equals_the_reference(reduced):
    """For every arch both packages serve, ``engine_backend`` names the
    reference's backend class (or None: static only)."""
    assert {"qwen2-vl-7b", "rwkv6-7b"} <= set(SERVED)
    for arch in SERVED:
        cfg, jcfg = get_config(arch), jget(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        mine, ref = engine_backend(cfg), jengine_backend(jcfg)
        assert (mine and mine.__name__) == (ref and ref.__name__), arch

