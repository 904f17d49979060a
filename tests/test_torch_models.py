"""Port model layers and the dense transformer against the JAX reference.

Inputs come from numpy seeds; weights from the reference's
``init_params`` converted by ``repro_torch.convert.params_from_jax``.
Tolerances: layers in f32 within ``tests/test_kernels.py``'s f32 TOL
(rtol 1e-4, atol 2e-4). Model logits run in bf16 compute like the
reference; the reference rounds attention scores and weights to bf16
inside ``gqa_attention`` where the port's prefill path (the flash op)
keeps them in f32, so logits agree within a few bf16 quanta: rtol = atol
= 4e-2 (2^-8 relative per rounding, compounded over two layers; logits
here are of order 1-4). Greedy tokens must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL32 = dict(rtol=1e-4, atol=2e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
ARCHS = ["codeqwen1.5-7b", "olmo-1b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- layers ---------------------------------------------------------------------


def test_config_reduced_matches_reference():
    for arch in ARCHS:
        j, t = jget(arch).reduced(), get_config(arch).reduced()
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
                  "qkv_bias", "tie_embeddings", "rope_theta", "q_dim",
                  "kv_dim"):
            assert getattr(j, f) == getattr(t, f), f
        full = get_config(arch)
        assert full.head_dim == jget(arch).head_dim == 128


def test_norms_rope_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 2, 5, 32), _rand(rng, 32)
    for jf, tf in ((JL.rmsnorm, L.rmsnorm), (JL.layernorm, L.layernorm)):
        np.testing.assert_allclose(
            tf(torch.tensor(x), torch.tensor(s)).numpy(),
            np.asarray(jf(jnp.asarray(x), jnp.asarray(s))), **TOL32)
        np.testing.assert_allclose(tf(torch.tensor(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), **TOL32)
    q = _rand(rng, 2, 5, 4, 16)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(torch.tensor(q), torch.tensor(pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6)),
        rtol=1e-4, atol=1e-3)      # f32 sin/cos of angles up to ~4e3
    w1, w2, w3 = _rand(rng, 32, 48), _rand(rng, 32, 48), _rand(rng, 48, 32)
    np.testing.assert_allclose(
        L.swiglu(*(torch.tensor(a) for a in (x, w1, w2, w3))).numpy(),
        np.asarray(JL.swiglu(*(jnp.asarray(a) for a in (x, w1, w2, w3)))),
        rtol=1e-4, atol=1e-3)      # f32 sums over 32 and 48 terms


def test_paged_cache_writers_match_jax():
    rng = np.random.default_rng(1)
    pages = _rand(rng, 2, 6, 4, 8)                 # (KV, P, page, dh)
    new = _rand(rng, 3, 2, 8)                      # (B, KV, dh)
    ids, offs = np.array([2, 0, 5], np.int32), np.array([1, 0, 3], np.int32)
    want = JL.paged_cache_append(jnp.asarray(pages), jnp.asarray(new),
                                 jnp.asarray(ids), jnp.asarray(offs))
    got = torch.tensor(pages)
    L.paged_cache_append(got, torch.tensor(new), torch.tensor(ids),
                         torch.tensor(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pool = _rand(rng, 2, 2, 6, 4, 8)               # (L, KV, P, page, dh)
    kv = _rand(rng, 2, 8, 2, 8)                    # (L, S, KV, dh)
    pids = np.array([4, 1], np.int32)
    want = JL.paged_cache_write_prompt(jnp.asarray(pool), jnp.asarray(kv),
                                       jnp.asarray(pids))
    got = torch.tensor(pool)
    L.paged_cache_write_prompt(got, torch.tensor(kv), torch.tensor(pids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the dense transformer on converted weights ---------------------------------


def _prefilled(arch, toks, plen, pids, num_pages=12, page=4):
    """Both packages: paged prefill of one prompt, KV written to pids."""
    jcfg, jp, cfg, tp = _setup(arch)
    lens = np.array([plen], np.int32)
    jlast, (jk, jv) = JT.paged_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                       jnp.asarray(lens))
    js = JT.init_paged_decode_state(jcfg, num_pages, page)
    js = JT.write_prefill_pages(jcfg, js, (jk[:, 0], jv[:, 0]),
                                jnp.asarray(pids))
    tlast, (tk, tv) = T.paged_prefill(cfg, tp, {"tokens": torch.tensor(toks)},
                                      torch.tensor(lens))
    ts = T.init_paged_decode_state(cfg, num_pages, page, device="cpu")
    T.write_prefill_pages(cfg, ts, (tk[:, 0], tv[:, 0]), torch.tensor(pids))
    return (jcfg, jp, js, jlast), (cfg, tp, ts, tlast)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_step_match_jax(arch):
    rng = np.random.default_rng(2)
    plen, gen = 7, 4
    toks = rng.integers(0, 256, (1, 8)).astype(np.int32)
    (jcfg, jp, js, jlast), (cfg, tp, ts, tlast) = _prefilled(
        arch, toks, plen, np.array([3, 5], np.int32))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL_BF16)
    assert int(tlast.argmax()) == int(jnp.argmax(jlast))
    pt = np.array([[3, 5, 7, 0]], np.int32)
    tok = int(jnp.argmax(jlast))
    for i in range(gen):
        args = (np.array([tok], np.int32), pt, np.array([plen + i], np.int32),
                np.array([True]))
        jl, js = JT.paged_decode_step(jcfg, jp, js, *map(jnp.asarray, args))
        tl = T.paged_decode_step(cfg, tp, ts, *map(torch.tensor, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        assert int(tl.argmax()) == int(jnp.argmax(jl)), f"step {i}"
        tok = int(jnp.argmax(jl))
    # the appended decode K/V landed in the same pages and rows
    np.testing.assert_allclose(ts.k_pages.float().numpy(),
                               np.asarray(js.k_pages, np.float32),
                               **TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_multi_matches_jax(arch):
    """The fused horizon: same tokens from both packages, masked slots and
    budget drop-outs included; the loop tensors advance in place."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (1, 8)).astype(np.int32)
    (jcfg, jp, js, jlast), (cfg, tp, ts, tlast) = _prefilled(
        arch, toks, 6, np.array([3, 5], np.int32))
    # slot 0: the prefilled request; slot 1 masked out; slot 2 live with a
    # budget of 2 on an empty cache (pages 7, 8)
    pending = np.array([int(jnp.argmax(jlast)), 9, 17], np.int32)
    lengths = np.array([6, 0, 0], np.int32)
    remaining = np.array([5, 5, 2], np.int32)
    table = np.array([[3, 5, 7, 0], [0, 0, 0, 0], [8, 9, 0, 0]], np.int32)
    mask = np.array([True, False, True])
    out_j, _, pj, lj, rj = JT.paged_decode_multi(
        jcfg, jp, js, *map(jnp.asarray, (pending, lengths, remaining, table,
                                         mask)), jnp.asarray(2), hmax=4)
    p_t, l_t, r_t = (torch.tensor(a) for a in (pending, lengths, remaining))
    out_t = T.paged_decode_multi(cfg, tp, ts, p_t, l_t, r_t,
                                 torch.tensor(table), torch.tensor(mask), 2,
                                 hmax=4)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    for got, want in ((p_t, pj), (l_t, lj), (r_t, rj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert out_t[2:].abs().sum() == 0 and out_t[:, 1].abs().sum() == 0


def test_paged_prefill_shared_and_copy_page_match_jax():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (1, 8)).astype(np.int32)
    (jcfg, jp, js, _), (cfg, tp, ts, _) = _prefilled(
        "codeqwen1.5-7b", toks, 8, np.array([3, 5], np.int32))
    js = JT.copy_kv_page(js, jnp.asarray(5), jnp.asarray(6))
    T.copy_kv_page(ts, 5, 6)
    suffix = rng.integers(0, 256, (1, 4)).astype(np.int32)
    args = ({"tokens": suffix}, np.array([3], np.int32),
            np.array([[3, 6, 0]], np.int32), np.array([8], np.int32))
    jl, (jk, _) = JT.paged_prefill_shared(
        jcfg, jp, js, {"tokens": jnp.asarray(suffix)},
        *map(jnp.asarray, args[1:]))
    tl, (tk, _) = T.paged_prefill_shared(
        cfg, tp, ts, {"tokens": torch.tensor(suffix)},
        *map(torch.tensor, args[1:]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    np.testing.assert_allclose(tk.float().numpy(),
                               np.asarray(jk, np.float32), **TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == forward(prompt + token) logits."""
    _, _, cfg, tp = _setup(arch, seed=1)
    rng = np.random.default_rng(5)
    B, S = 2, 8
    full = torch.tensor(rng.integers(0, 256, (B, S)).astype(np.int32))
    last, state = T.prefill(cfg, tp, {"tokens": full[:, :S - 1]}, 32)
    step, _ = T.decode_step(cfg, tp, state, full[:, S - 1])
    want = T.forward(cfg, tp, {"tokens": full})
    np.testing.assert_allclose(last.numpy(), want[:, S - 2].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(step.numpy(), want[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_paged_decode_matches_dense_decode():
    """paged_decode_step reproduces the dense decode_step trajectory
    (same greedy tokens, close logits)."""
    _, _, cfg, tp = _setup("codeqwen1.5-7b")
    plen, gen, page = 6, 5, 4
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32))
    logits_d, st = T.prefill(cfg, tp, {"tokens": toks[:, :plen]},
                             cache_len=plen + gen)
    ps = T.init_paged_decode_state(cfg, num_pages=8, page_size=page,
                                   device="cpu")
    lengths = torch.tensor([plen], dtype=torch.int32)
    last, (k, v) = T.paged_prefill(cfg, tp, {"tokens": toks}, lengths)
    T.write_prefill_pages(cfg, ps, (k[:, 0], v[:, 0]),
                          torch.tensor([1, 2], dtype=torch.int32))
    np.testing.assert_allclose(last.numpy(), logits_d.numpy(), rtol=0,
                               atol=0)
    pt = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    tok_d = tok_p = logits_d.argmax(-1).to(torch.int32)
    live = plen
    for i in range(gen):
        lg_d, st = T.decode_step(cfg, tp, st, tok_d)
        lg_p = T.paged_decode_step(cfg, tp, ps, tok_p, pt,
                                   torch.tensor([live], dtype=torch.int32),
                                   torch.tensor([True]))
        tok_d = lg_d.argmax(-1).to(torch.int32)
        tok_p = lg_p.argmax(-1).to(torch.int32)
        assert int(tok_d[0]) == int(tok_p[0]), f"diverged at step {i}"
        np.testing.assert_allclose(lg_d.numpy(), lg_p.numpy(), rtol=0.05,
                                   atol=0.05)
        live += 1


def test_init_params_shapes_and_dtypes_match_reference():
    """``init_params`` gives the reference's names and shapes; matrices
    are stored in bf16 once, norm scales in f32."""
    for arch in ARCHS:
        jcfg, jp, cfg, _ = _setup(arch)
        tp = T.init_params(cfg, seed=0, device="cpu")
        jshapes = jax.tree.map(lambda a: a.shape, jp)
        tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
        assert tshapes == jshapes
        for name, t in tp["blocks"].items():
            want = torch.float32 if name in T.F32_PARAMS else torch.bfloat16
            assert t.dtype == want, name
        assert tp["embed"].dtype == torch.bfloat16
        std = tp["blocks"]["wq"].float().std().item()
        assert abs(std * np.sqrt(cfg.d_model) - 0.88) < 0.1  # trunc. N(0,1)
