"""The mesh slice for the MoE family on the CPU, serving: meshes of 2 and 4
ranks as processes over ``gloo`` (``_torch_mesh_worker.py``), held against
the port at one rank and the reference on the same converted weights.

Reduced olmoe-1b-7b (GQA-MoE: TP attention, its 2 KV heads expanded to 4
at (1, 4) as the dense family's) and deepseek-v2-lite-16b (MLA-MoE:
head-parallel MLA, one shared expert) at meshes (data, model) (1, 2),
(2, 2) and (1, 4): the routed experts split over the model axis (4
experts: 2 or 1 a rank), the tokens dispatched within the data axis'
groups at the whole batch's capacity over G (the reference's
group-local dispatch). One launch a mesh holds both archs' tasks.

The one-rank baseline of a mesh with G data ranks is the port in this
process with the groups of a shard context of ``dp_size`` G and no mesh
(``layers.moe_ffn`` dispatches every group's rows one after the other),
and the reference's counterpart runs under its ``set_shard_ctx(dp_size=
G)`` inside a one-device ``jax.sharding.Mesh``: a G-group dispatch drops
other claims than one group's.

Checks, an arch and a mesh at a time:
- the sharded draw is the one-rank draw's slices, bit for bit;
- f32 (both compute dtypes of the port f32 in the task, the params the
  f32 masters): the prefill's and 8 teacher-forced decode steps' logits
  within 1e-4 of one rank's, the same bits on every rank, the state
  after them gathered whole (deepseek's latent rows channel for channel
  from the ranks' even slices) within 1e-4 of one rank's, and the
  prompt's route keep masks equal to one rank's exactly (in f32 no route
  parts at a bf16 tie); at (2, 2) also a prompt of 24 tokens, whose
  capacity 15 does not divide into 2 groups, so the data ranks dispatch
  the whole batch as one;
- bf16 (as the port serves): the prefill's and first decode step's
  logits within ``TOL_BF16`` (4e-2) of the reference's op-by-op run on
  one device routed as the sharded run routed
  (``_torch_parity.reference_routes``), every token that routes
  otherwise a near-tie (``routes_differ_at_ties_only``); no token
  equality is asserted in bf16;
- ``launch.serve``'s static mode (greedy, f32) gives one rank's tokens;
- deepseek's engine at (1, 2) and (1, 4) (bf16, greedy, fused horizons
  of 4): one rank's ledger exactly, the byte counts a rank's share (its
  channels of the latent row), the same tokens on every rank and one
  rank's token counts.

Also on one process: the port's group-local ``moe_ffn`` against the
reference's under ``dp_size`` 2, where the capacity divides into the
groups and where it falls back to one group; and the dry run's MoE
serving cells on the (16, 16) mesh, cut to 1 and 2 layers and at full
depth, their FLOPs and collective bytes exactly as ``_serve_figures``
counts them.

Every multi-rank run joins a file store under a temporary directory with
a 60 s timeout, one torch thread a rank, and is killed and failed at its
deadline: a dead rank cannot hang the suite.
"""

import contextlib
import copy
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import compute_dtype
from _torch_parity import (ledger, reference_routes,
                           routes_differ_at_ties_only, setup)
from repro.configs import get_config as jget
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun, serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh, production_abstract_mesh
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.runtime import Engine, EngineConfig
from test_torch_mesh import CPU, engine_trace, launched
from test_torch_mesh import _inputs

ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
ENGINE_MESHES = [(1, 2), (1, 4)]
CACHE, STEPS = 16, 8
#: the (2, 2) fallback prompt: 4 x 6 tokens, capacity 15 (odd)
FALLBACK_S = 6
TOL32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
ENGINE_CFG = dict(num_slots=3, page_size=8, num_pages=25,
                  max_pages_per_seq=4, prefill_bucket=8, greedy=True,
                  horizon=4)
SAMPLED = ["--mode", "static", "--greedy", *CPU]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _models(arch):
    """(reference config, its params, the port's config, its bf16
    params, its f32 masters)."""
    jcfg, jp, cfg, params = setup(arch)
    return jcfg, jp, cfg, params, params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu", master=True)


def _moe_tasks(mesh):
    """Both archs' tasks in one launch of a mesh: the draw (seed 3), the
    f32 static run with its state and keeps, the bf16 one with its
    routes, serve's static mode; at (2, 2) the fallback prompt; at data
    axes of one rank deepseek's engine."""
    archs = {}
    for arch in ARCHS:
        _, _, cfg, params, master = _models(arch)
        tokens, teacher = (torch.as_tensor(t) for t in _inputs(cfg))
        tasks = archs[arch] = [
            ("draw", 3),
            ("static", master, tokens, teacher, CACHE,
             {"f32": True, "state": True, "keeps": True}),
            ("static", params, tokens, teacher[:, :1], CACHE,
             {"name": "bf16", "routes": True}),
            ("sample", ["--arch", arch, *SAMPLED], {"f32": True})]
        if mesh == (2, 2):
            tasks.append(("static", master, tokens[:, :FALLBACK_S],
                          teacher[:, :2], CACHE,
                          {"f32": True, "name": "fallback", "keeps": True}))
        if cfg.mla is not None and mesh in ENGINE_MESHES:
            tasks.append(("engine", params, engine_trace(cfg), ENGINE_CFG))
    return (archs,)


def _ranks(mesh, factory, arch) -> list[dict]:
    return [{"coords": r["coords"], **r[arch]}
            for r in launched("moe", mesh, factory, _moe_tasks)]


@contextlib.contextmanager
def _groups(g: int):
    """The port in this process dispatching in ``g`` data-parallel groups
    (a shard context of ``dp_size`` g without a mesh: every row here)."""
    token = L.set_shard_ctx("data", None, g)
    try:
        yield
    finally:
        L.reset_shard_ctx(token)


@contextlib.contextmanager
def _reference_groups(g: int):
    """The reference dispatching in ``g`` groups: its shard context of
    ``dp_size`` g inside a one-device mesh with its axis names."""
    if g == 1:
        yield
        return
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    token = JL.set_shard_ctx("data", "model", dp_size=g, tp_size=1)
    try:
        with mesh:
            yield
    finally:
        JL.reset_shard_ctx(token)


# --- serving ----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_draw_is_the_one_rank_draw(arch, mesh, tmp_path_factory):
    """Every rank's ``init_params(local=)`` draw is its slices of the
    one-rank draw, bit for bit (its experts of the routed ones, its
    heads of w_uk and w_uv), and holds less than the whole model."""
    _, _, cfg, _, _ = _models(arch)
    whole = get_model(cfg).init_params(cfg, 3, device="cpu")
    abstract = AbstractMesh(mesh, ("data", "model"))
    specs = sh.param_pspecs(whole, abstract)
    assert sh.leaf_at(specs, ("blocks", "moe", "w_gate"))[1] == "model"
    for r in _ranks(mesh, tmp_path_factory, arch):
        abstract.coords = r["coords"]
        want = dict(sh.flatten(sh.shard_tree(whole, specs, abstract)))
        got = dict(sh.flatten(r["draw"]))
        assert got.keys() == want.keys()
        for path, t in want.items():
            assert torch.equal(got[path], t), (r["coords"], path)
        assert sum(t.numel() for t in got.values()) < \
            sum(t.numel() for _, t in sh.flatten(whole))


@functools.cache
def _one_rank_f32(arch, g: int, e: int, s: int, steps: int):
    """The one-rank port in f32 with ``g`` groups: the prompt's (its
    first ``s`` tokens) route keeps, the prefill's and ``steps``
    teacher-forced decode steps' logits, and the state after them (KV
    heads stored ``e`` times)."""
    _, _, cfg, _, master = _models(arch)
    api = get_model(cfg)
    tokens, teacher = (torch.as_tensor(t) for t in _inputs(cfg))
    batch = {"tokens": tokens[:, :s]}
    with compute_dtype(True), torch.no_grad(), _groups(g):
        keeps = api.forward(cfg, master, batch, return_route_keep=True)[1]
        logits, state = api.prefill(cfg, master, batch, CACHE, kv_expand=e)
        out = [logits]
        for j in range(steps):
            logits, state = api.decode_step(cfg, master, state, teacher[:, j])
            out.append(logits)
    return torch.stack(out).numpy(), state, keeps


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_one_rank_in_f32(arch, mesh,
                                                 tmp_path_factory):
    """f32: the sharded prefill and 8 teacher-forced decode steps give
    one rank's logits within 1e-4 (one rank dispatching in the mesh's
    data groups), the same bits on every rank; the prompt's route keep
    masks equal one rank's; the state after them, gathered whole, within
    1e-4 of one rank's: deepseek's latent rows channel for channel from
    the ranks' even slices of them, olmoe's K/V heads (expanded at (1,
    4))."""
    _, _, cfg, _, _ = _models(arch)
    ranks = _ranks(mesh, tmp_path_factory, arch)
    e = L.serve_kv_expand(cfg, mesh[1])
    one, state, keeps = _one_rank_f32(arch, mesh[0], e, _inputs(cfg)[0]
                                      .shape[1], STEPS)
    got = ranks[0]["static"]
    for r in ranks[1:]:
        assert torch.equal(r["static"]["logits"], got["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), one, **TOL32)
    assert torch.equal(got["keeps"], keeps)
    if mesh[0] > 1:         # groups drop other claims than one group
        with compute_dtype(True), torch.no_grad():
            whole = get_model(cfg).forward(
                cfg, _models(arch)[4],
                {"tokens": torch.as_tensor(_inputs(cfg)[0])},
                return_route_keep=True)[1]
        assert not torch.equal(whole, keeps)
    mine, want = got["state"].kv, state.kv
    assert mine.shape == want.shape, (mine.shape, want.shape)
    np.testing.assert_allclose(mine.float().numpy(), want.float().numpy(),
                               **TOL32)
    assert got["state"].pos == state.pos


@pytest.mark.parametrize("arch", ARCHS)
def test_fallback_dispatches_the_whole_batch(arch, tmp_path_factory):
    """At (2, 2) a prompt of 4 x 6 tokens: its capacity 15 does not
    divide into the 2 groups, so the data ranks dispatch the whole batch
    as one group (gathered over data) and keep their rows: the keep
    masks and the logits of the prefill and 2 decode steps one rank's in
    f32."""
    _, _, cfg, _, _ = _models(arch)
    assert L.moe_dims(cfg, 4 * FALLBACK_S).capacity % 2
    ranks = _ranks((2, 2), tmp_path_factory, arch)
    one, _, keeps = _one_rank_f32(arch, 2, 1, FALLBACK_S, 2)
    _, _, keeps1 = _one_rank_f32(arch, 1, 1, FALLBACK_S, 2)
    assert torch.equal(keeps, keeps1)
    got = ranks[0]["fallback"]
    for r in ranks[1:]:
        assert torch.equal(r["fallback"]["logits"], got["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), one, **TOL32)
    assert torch.equal(got["keeps"], keeps)


@functools.cache
def _reference_routed(arch, g: int, picks: tuple):
    """The reference's prefill and first decode step logits op by op on
    one device with ``g`` groups, routed to ``picks``; and the router
    probabilities it computed."""
    jcfg, jp, cfg, _, _ = _models(arch)
    api = jget_model(jcfg)
    tokens, teacher = _inputs(cfg)
    with reference_routes([np.asarray(p) for p in picks]) as probs, \
            jax.disable_jit(), _reference_groups(g):
        logits, state = api.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                                    CACHE)
        nxt, _ = api.decode_step(jcfg, jp, state, jnp.asarray(teacher[:, 0]))
    return np.stack([np.asarray(logits, np.float32),
                     np.asarray(nxt, np.float32)]), probs


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_follows_the_reference_in_bf16(arch, mesh,
                                                       tmp_path_factory):
    """bf16: the sharded prefill's and first decode step's logits within
    4e-2 of the reference's on one device (in the mesh's data groups),
    routed as the sharded run routed, the same bits on every rank; every
    token whose routing differs from the reference's own is a near-tie."""
    ranks = _ranks(mesh, tmp_path_factory, arch)
    got = ranks[0]["bf16"]
    for r in ranks[1:]:
        assert torch.equal(r["bf16"]["logits"], got["logits"])
    routes = got["routes"]
    want, probs = _reference_routed(arch, mesh[0], tuple(
        tuple(map(tuple, idx)) for _, idx in routes))
    np.testing.assert_allclose(got["logits"].float().numpy(), want,
                               **TOL_BF16)
    routes_differ_at_ties_only(routes, probs)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_static_mode_serves_one_rank_tokens(arch, mesh, tmp_path_factory):
    """``launch.serve``'s static mode, greedy in f32 (``--batch 4
    --prompt-len 8 --gen 2``): every rank draws its slices from the seed
    and picks one rank's tokens."""
    _, _, cfg, _, _ = _models(arch)
    args = serve.parse_args(["--arch", arch, *SAMPLED])
    with compute_dtype(True), torch.no_grad(), _groups(mesh[0]):
        one = serve.static_decode(cfg, serve.init_params(cfg, args), args)[0]
    assert one.shape == (args.batch, args.gen)
    for r in _ranks(mesh, tmp_path_factory, arch):
        np.testing.assert_array_equal(r["sample"], one)


@functools.cache
def _one_rank_engine():
    _, _, cfg, params, _ = _models("deepseek-v2-lite-16b")
    return Engine(cfg, params, EngineConfig(**ENGINE_CFG)).run(
        copy.deepcopy(engine_trace(cfg)))


@pytest.mark.parametrize("mesh", ENGINE_MESHES, ids=str)
def test_sharded_engine_gives_one_rank_ledger(mesh, tmp_path_factory):
    """deepseek's engine on a seeded 6-request trace: one rank's ledger
    exactly but the byte counts, a rank's share (its 40 / tp channels of
    the latent row a token and layer); the same tokens on every rank and
    one rank's token counts."""
    ranks = _ranks(mesh, tmp_path_factory, "deepseek-v2-lite-16b")
    want, got = ledger(_one_rank_engine()), ledger(ranks[0]["engine"])
    for f in ("page_bytes", "cache_bytes_alloc", "kv_bytes_peak"):
        assert got.pop(f) * mesh[1] == want.pop(f), f
    assert got == want
    toks = [{r.rid: r.generated for r in rk["engine"].completed}
            for rk in ranks]
    assert all(t == toks[0] for t in toks)
    assert {r.rid: len(r.generated) for r in _one_rank_engine().completed} \
        == {rid: len(g) for rid, g in toks[0].items()}


# --- group-local dispatch on one process --------------------------------------------


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("N", [32, 24], ids=["groups", "fallback"])
def test_group_local_moe_ffn_matches_reference(N, replay):
    """The port's ``moe_ffn`` in 2 groups against the reference's under
    its ``set_shard_ctx(dp_size=2)`` on a one-device mesh, reduced
    deepseek's experts in f32: N 32 (capacity 20, 10 a group) and N 24
    (capacity 15, which falls back to one group), with and without a
    replayed drop population. Keep masks equal, outputs within f32 TOL;
    the 2 groups keep other claims than one group where they divide, the
    fallback exactly one group's."""
    jcfg, cfg = jget("deepseek-v2-lite-16b").reduced(), \
        get_config("deepseek-v2-lite-16b").reduced()
    jp = JL.init_moe_params(jax.random.PRNGKey(N), jcfg, 64)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, 64)).astype(np.float32)
    ko = rng.random((N, 2)) < 0.7 if replay else None
    jd, td = JL.moe_dims(jcfg, N), L.moe_dims(cfg, N)
    assert jd.capacity == td.capacity == {32: 20, 24: 15}[N]
    with _reference_groups(2):
        jy, _, jk = JL.moe_ffn(jnp.asarray(x), jp, jd, return_keep=True,
                               keep_override=None if ko is None
                               else jnp.asarray(ko))
    kw = dict(return_keep=True, keep_override=None if ko is None
              else torch.tensor(ko))
    with _groups(2):
        ty, tk = L.moe_ffn(torch.tensor(x), tp, td, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    y1, k1 = L.moe_ffn(torch.tensor(x), tp, td, **kw)
    if N == 24:
        assert torch.equal(ty, y1) and torch.equal(tk, k1)
    elif not replay:
        assert not torch.equal(tk, k1)


# --- the dry run's serving cells --------------------------------------------------

CELLS = [(arch, shape) for arch in ARCHS
         for shape in ("prefill_32k", "decode_32k")]
TP = DP = 16


def _serve_figures(cfg, shape) -> dict:
    """FLOPs, kernel FLOPs and collective bytes a chip of a MoE serving
    cell on the (16, 16) mesh, rank 0 (``b`` rows of the batch, ``n``
    tokens, one head a rank): the projections and einsums (bf16 products
    a chip), the kernels' formulas (``kernels.meta``: olmoe's flash or
    decode attention, the grouped GEMM's three products over the rank's
    E / 16 experts at the group capacity C / 16) and the head's vocabulary
    columns. Collectives: the embedding's all-reduce and a layer's two
    (wo's and the MoE's: the rank's experts and its shared experts'
    partial sums in one) of the (n, D) bf16 activations; deepseek's MLA
    gathers its latent and rope columns whole (n (r + dr) bf16 a layer),
    and its decode attends the cache's channels it holds (w = (r + dr) /
    16 of each row): every head's [q_lat | q_rope] gathered, the scores
    over its channels all-reduced in f32 (b H T), the weighed channels
    gathered (b H (r + dr))."""
    s = SHAPES[shape]
    b = s.global_batch // DP
    S = 1 if s.kind == "decode" else s.seq_len
    T, n = s.seq_len, b * S
    D, Lc, m = cfg.d_model, cfg.num_layers, cfg.moe
    H, hl, El = cfg.num_heads, cfg.num_heads // TP, m.num_experts // TP
    cap = (L.moe_dims_dropless(cfg, s.global_batch) if s.kind == "decode"
           else L.moe_dims(cfg, s.global_batch * s.seq_len)).capacity
    experts = 6 * El * cap // DP * D * m.d_ff_expert
    layer = 2 * n * D * m.num_experts + experts            # router, experts
    gather = 0
    if cfg.mla is None:
        dh, kv = cfg.head_dim, cfg.num_kv_heads // TP
        layer += 2 * n * D * dh * (2 * hl + 2 * kv)
        attn = 4 * b * hl * dh * (T if s.kind == "decode"
                                  else S * (S + 1) // 2)
        kernel = attn + experts
        layer += attn
    else:
        a = cfg.mla
        r, dr, dn, dv = (a.kv_lora_rank, a.qk_rope_head_dim,
                         a.qk_nope_head_dim, a.v_head_dim)
        layer += 2 * n * D * (hl * (dn + dr) + (r + dr) // TP)
        layer += 2 * n * hl * r * (dn + dv) + 2 * n * hl * dv * D
        layer += 6 * n * D * m.d_ff_expert * m.num_shared_experts // TP
        gather = n * (r + dr) * 2
        if s.kind == "decode":
            layer += 2 * 2 * b * H * T * (r + dr) // TP
            gather += 2 * n * H * (r + dr) * 2
        else:
            layer += 2 * b * hl * S * S * (2 * r + dr)
        kernel = experts
    reduce = (2 * Lc + 1) * n * D * 2
    if cfg.mla is not None and s.kind == "decode":
        reduce += Lc * b * H * T * 4
    return {"flops": Lc * layer + 2 * b * D * cfg.vocab_size // TP,
            "kernel_flops": Lc * kernel,
            "all-gather": Lc * gather, "all-reduce": reduce,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}


@pytest.mark.parametrize("arch,shape", CELLS, ids=str)
def test_dryrun_moe_serving_cells(arch, shape):
    """olmoe-1b-7b's and deepseek-v2-lite-16b's prefill_32k and
    decode_32k on the (16, 16) mesh, traced cut to 1 and 2 layers and at
    full depth (a decode cell's one token against the cache's last row):
    each on rank 0's shards with its local argument bytes, its FLOPs,
    kernel FLOPs and collectives exactly ``_serve_figures``; a decode
    cell's logits the rank's vocabulary columns."""
    mesh = production_abstract_mesh()
    for layers in (1, 2, None):
        cfg = get_config(arch) if layers is None else dataclasses.replace(
            get_config(arch), num_layers=layers)
        cell, rec = dryrun.trace_cell(cfg, shape, False)
        assert rec["ok"] and rec["kind"] == SHAPES[shape].kind, rec
        assert rec["memory"]["argument_bytes"] == sum(
            math.prod(sh.local_shape(t.shape, sh.leaf_at(specs, path), mesh))
            * t.element_size()
            for arg, specs in zip(cell.args, cell.in_pspecs)
            for path, t in sh.flatten(arg)
            if isinstance(t, torch.Tensor) and t.is_meta)
        assert rec["memory"]["peak_live_bytes"] > 0
        want = _serve_figures(cfg, shape)
        assert {"flops": rec["cost"]["flops"],
                "kernel_flops": rec["cost"]["kernel_flops"],
                **rec["collective_bytes_per_chip"]} == want, (layers, want)
        if cell.kind == "decode":
            assert rec["memory"]["output_bytes"] >= \
                SHAPES[shape].global_batch // DP * cfg.vocab_size // TP * 4
