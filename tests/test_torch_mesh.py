"""The port's tensor-parallel serving on the CPU: meshes of 2 and 4 ranks
as processes over ``gloo`` (``_torch_mesh_worker.py``), held against the
port at one rank and the reference on the same converted weights.

Reduced ``codeqwen1.5-7b`` (RMSNorm, QKV bias) and reduced
``command-r-35b`` (LayerNorm, no biases) at meshes (1, 2), (2, 2) and
(1, 4) (data, model): at (1, 4) their 2 KV heads are expanded to 4
(``serve_kv_expand``) and wk/wv cut within a head, so each rank gathers
them. Tolerances: the sharded run rounds each row-parallel product's
partial sums to bf16 and sums them over the model axis in bf16 (as the
reference's partitioner sums a bf16 dot), where one rank's GEMM rounds
once, so its logits differ from the one-rank port's by a few bf16
quanta, compounded over two layers and eight decode steps: they are
held within ``test_torch_models.py``'s TOL_BF16 (rtol = atol = 4e-2) of
the one-rank port and of the reference (0.2% of them miss the kernels'
bf16 TOL of 2e-2, by up to 0.044 in logits of order 1). Greedy choices
must be consistent (``_torch_parity.GREEDY_GAP``). The engine's ledger
must equal the one-rank engine's, its byte counts a rank's share.

Every multi-rank run joins a file store under ``tmp_path`` with a 60 s
timeout, one torch thread a rank, and is killed and failed at its
deadline: a dead rank cannot hang the suite.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import GREEDY_GAP, greedy_gap, ledger, setup
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh, production_abstract_mesh
from repro_torch.models import griffin as TG
from repro_torch.models import transformer as T
from repro_torch.runtime import Engine, EngineConfig, poisson_trace
from repro_torch.runtime import vlm_extras_fn

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
ARCHS = ["codeqwen1.5-7b", "command-r-35b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
B, S, CACHE, STEPS = 4, 8, 16, 8
ENGINE = dict(num_slots=3, page_size=8, num_pages=25, max_pages_per_seq=4,
              prefill_bucket=8, greedy=True, horizon=4)
DEADLINE = 120.0


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(tmp_path, mesh, archs: dict, configs=None) -> list[dict]:
    """Each rank's results of ``archs`` (arch -> tasks; ``configs`` as the
    worker's job["configs"]) on ``mesh``: one process a rank, all joined
    by ``DEADLINE`` or killed and failed."""
    world = mesh[0] * mesh[1]
    job, out = tmp_path / "job.pt", tmp_path / "out"
    torch.save({"mesh": mesh, "archs": archs, "configs": configs or {}},
               job)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(job), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE)[0].decode()[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{mesh}: ranks did not finish in {DEADLINE} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


@functools.cache
def _models(arch):
    return setup(arch)


@pytest.fixture(params=ARCHS)
def models(request):
    return _models(request.param)


def engine_trace(cfg):
    """The engine tests' seeded 6-request trace (vlm requests with their
    patch embeddings)."""
    return poisson_trace(6, mean_interarrival=1.0, prompt_lens=(6, 12),
                         gen_lens=(4, 9), vocab_size=cfg.vocab_size, seed=0,
                         extras_fn=vlm_extras_fn(cfg)
                         if cfg.family == "vlm" else None)


_LAUNCHED: dict = {}


def launched(name, mesh, factory, tasks) -> list[dict]:
    """Each rank's results of one launch on ``mesh`` a ``name``, made
    once: ``tasks(mesh)`` gives its {arch: tasks} (and its configs)."""
    if (name, mesh) not in _LAUNCHED:
        _LAUNCHED[name, mesh] = run_ranks(factory.mktemp(name), mesh,
                                          *tasks(mesh))
    return _LAUNCHED[name, mesh]


def _launched(mesh, tmp_path_factory) -> list[dict]:
    return launched("mesh", mesh, tmp_path_factory, _dense_tasks)


def _dense_tasks(mesh):
    """Both archs' draw (seed 3) and static run, at (1, 2) their engine
    runs, at (2, 2) and (1, 4) the refusals."""
    archs = {}
    for arch in ARCHS:
        _, _, cfg, params = _models(arch)
        tokens, teacher = _inputs(cfg)
        archs[arch] = [("draw", 3), ("static", params, torch.as_tensor(
            tokens), torch.as_tensor(teacher), CACHE)]
        if mesh == (1, 2):
            archs[arch].append(("engine", params, engine_trace(cfg),
                                ENGINE))
    if mesh in REFUSED_AT:
        archs[ARCHS[0]].append(("refuse", [argv for argv, _ in
                                           REFUSED_AT[mesh]]))
    return (archs,)


@pytest.fixture(scope="module", params=MESHES, ids=str)
def ranks(request, tmp_path_factory):
    return request.param, _launched(request.param, tmp_path_factory)


CPU = ["--device", "cpu", "--batch", "4", "--prompt-len", "8", "--gen", "2"]
# what a mesh of more than one rank refuses, and a word its reason names
REFUSED = [(["--mode", "pool", *CPU], "pool"),
           (["--mode", "fleet", *CPU], "fleet"),
           (["--mode", "engine", *CPU], "data axis")]
# reduced whisper-tiny's 2 KV heads over 4 model ranks: the split cuts a
# head (whisper stores no expanded heads)
REFUSED_CUT = [(["--arch", "whisper-tiny", "--mode", "static", *CPU],
                "cuts a head")]
REFUSED_AT = {(2, 2): REFUSED, (1, 4): REFUSED_CUT}


def test_multi_rank_meshes_refuse_what_is_not_sharded(tmp_path_factory):
    """Under the (2, 2) mesh, pool, fleet and the engine over a data
    axis of two raise NotImplementedError by name, and under (1, 4)
    whisper-tiny, whose split there cuts a head: no fallback to one rank
    or to replication. (The MoE family serves sharded:
    ``test_torch_mesh_moe.py``.)"""
    for mesh, refused in REFUSED_AT.items():
        for r in _launched(mesh, tmp_path_factory):
            got = r[ARCHS[0]]["refuse"]
            assert len(got) == len(refused)
            for (argv, word), msg in zip(refused, got):
                assert msg is not None and word in msg, (argv, msg)


def _inputs(cfg, rng=None):
    """Tokens (B, S) and teacher tokens (B, STEPS) from ``rng`` (a numpy
    generator seeded 1 by default)."""
    rng = rng or np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return tokens, rng.integers(0, cfg.vocab_size, (B, STEPS),
                                dtype=np.int32)


def _static_logits(prefill, decode_step, tokens, teacher):
    """The prefill's and each teacher-forced decode step's logits."""
    logits, state = prefill(tokens)
    out = [np.asarray(logits, np.float32)]
    for j in range(teacher.shape[1]):
        logits, state = decode_step(state, teacher[:, j])
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _port_static(cfg, params, tokens, teacher, e=1):
    with torch.no_grad():
        return _static_logits(
            lambda t: T.prefill(cfg, params, {"tokens": torch.as_tensor(t)},
                                CACHE, kv_expand=e),
            lambda st, t: T.decode_step(cfg, params, st, torch.as_tensor(t)),
            tokens, teacher)


@functools.cache
def _reference_static(arch, e):
    jcfg, jp, cfg, _ = _models(arch)
    api = jget_model(jcfg)
    prefill = jax.jit(functools.partial(api.prefill, jcfg, cache_len=CACHE,
                                        kv_expand=e))
    decode = jax.jit(functools.partial(api.decode_step, jcfg))
    return _static_logits(
        lambda t: prefill(jp, {"tokens": jnp.asarray(t)}),
        lambda st, t: decode(jp, st, jnp.asarray(t)), *_inputs(cfg))


def test_sharded_serving_matches_one_rank_and_the_reference(models, ranks):
    """The sharded draw is the one-rank draw's slices bit for bit; the
    prefill and 8 teacher-forced static decode steps match the one-rank
    port and the reference, the same bits on every rank; at (1, 2) the
    engine on a seeded 6-request trace gives the one-rank ledger and
    tokens."""
    jcfg, jp, cfg, params = models
    arch = cfg.name.removesuffix("-smoke")
    mesh, ranks = ranks
    ranks = [{"coords": r["coords"], **r[arch]} for r in ranks]
    tokens, teacher = _inputs(cfg)

    whole = T.init_params(cfg, 3, device="cpu")
    abstract = AbstractMesh(mesh, ("data", "model"))
    specs = sh.param_pspecs(whole, abstract)
    for r in ranks:
        abstract.coords = r["coords"]
        want = sh.shard_tree(whole, specs, abstract)
        for (path, got), (_, exp) in zip(sh.flatten(r["draw"]),
                                         sh.flatten(want)):
            assert torch.equal(got, exp), (r["coords"], path)
        assert sum(t.numel() for _, t in sh.flatten(r["draw"])) < \
            sum(t.numel() for _, t in sh.flatten(whole))

    e = mesh[1] // 2 if mesh[1] == 4 else 1      # the KV expansion
    one = _port_static(cfg, params, tokens, teacher)
    ref = _reference_static(arch, e)
    got = ranks[0]["static"]["logits"].float().numpy()
    for r in ranks[1:]:
        assert torch.equal(r["static"]["logits"], ranks[0]["static"]["logits"])
    assert ranks[0]["static"]["cache_heads"] == \
        cfg.num_kv_heads * e // mesh[1]
    assert ranks[0]["static"]["cache_rows"] == B // mesh[0]
    np.testing.assert_allclose(got, one, **TOL_BF16)
    np.testing.assert_allclose(got, ref, **TOL_BF16)
    for step in range(STEPS + 1):       # greedy picks: consistent
        pick = got[step].argmax(-1)
        gap = one[step].max(-1) - one[step][np.arange(B), pick]
        assert gap.max() <= GREEDY_GAP, (step, gap)

    if mesh == (1, 2):
        rep = Engine(cfg, params, EngineConfig(**ENGINE)).run(
            engine_trace(cfg))
        want, got = ledger(rep), ledger(ranks[0]["engine"])
        for f in ("page_bytes", "cache_bytes_alloc", "kv_bytes_peak"):
            assert got.pop(f) * mesh[1] == want.pop(f), f
        assert got == want
        tokens = [{r.rid: r.generated for r in rk["engine"].completed}
                  for rk in ranks]
        assert tokens[0] == tokens[1]
        for r in rep.completed:
            if tokens[0][r.rid] != r.generated:
                gap = greedy_gap(jcfg, jp, ranks[0]["engine"].completed[
                    [q.rid for q in ranks[0]["engine"].completed].index(
                        r.rid)])
                assert gap <= GREEDY_GAP, (r.rid, gap)


# --- KV expansion at one rank -----------------------------------------------------


def test_kv_expand_matches_the_reference_transformer(models):
    """``prefill(kv_expand=2)`` stores each KV head twice (the reference's
    layout and values), ``init_decode_state(kv_expand=2)`` has the
    reference's shapes, and a decode step from the expanded cache gives
    the reference's logits."""
    jcfg, jp, cfg, params = models
    tokens, teacher = _inputs(cfg)
    api = jget_model(jcfg)
    jl, jst = api.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, CACHE,
                          kv_expand=2)
    with torch.no_grad():
        tl, st = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                           CACHE, kv_expand=2)
        assert st.k.shape == jst.k.shape == (
            cfg.num_layers, B, CACHE, 2 * cfg.num_kv_heads, cfg.head_dim)
        for mine, want in ((st.k, jst.k), (st.v, jst.v)):
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **TOL_BF16)
        assert torch.equal(st.k[:, :, :, 0::2], st.k[:, :, :, 1::2])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        tl, _ = T.decode_step(cfg, params, st, torch.as_tensor(teacher[:, 0]))
    jl, _ = api.decode_step(jcfg, jp, jst, jnp.asarray(teacher[:, 0]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    empty = T.init_decode_state(cfg, B, CACHE, device="cpu", kv_expand=2)
    jempty = api.init_decode_state(jcfg, B, CACHE, kv_expand=2)
    assert empty.k.shape == jempty.k.shape


def test_kv_expand_matches_the_reference_griffin():
    """Griffin's MQA head replicated: the expanded ring cache, its
    shapes and a decode step from it against the reference's."""
    jcfg, jp, cfg, params = setup("recurrentgemma-9b")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11), dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2,), dtype=np.int32)
    api = jget_model(jcfg)
    jl, jst = jax.jit(functools.partial(api.prefill, jcfg, kv_expand=2))(
        jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl, st = TG.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                            kv_expand=2)
        assert st.k.shape == jst.k.shape
        assert st.k.shape[3] == 2 * cfg.num_kv_heads
        for mine, want in ((st.k, jst.k), (st.v, jst.v)):
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **TOL_BF16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        tl, _ = TG.decode_step(cfg, params, st, torch.as_tensor(nxt))
    jl, _ = jax.jit(functools.partial(api.decode_step, jcfg))(
        jp, jst, jnp.asarray(nxt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    assert TG.init_decode_state(cfg, 2, device="cpu", kv_expand=2).k.shape \
        == api.init_decode_state(jcfg, 2, kv_expand=2).k.shape


# --- the entry point and the dry run ----------------------------------------------


def test_serve_pod_mesh_needs_its_256_ranks():
    """A production mesh in a world of another size raises, naming the
    ranks it needs: no fallback to one rank or to replication."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        serve.main(["--mesh", "pod", "--device", "cpu"])


def test_dryrun_decode_cell_bytes_and_collectives():
    """command-r-35b decode_32k on the (16, 16) mesh: the recorded
    argument bytes are the local shards' sum; the collectives are two
    all-reduces a layer of the local (B, 1, D) bf16 (B 8 of 128 over 16
    data ranks) plus the embedding's one, and the all-gathers of wk/wv
    (8 KV heads cut over 16 ranks) a layer; the V-sharded logits are
    returned as they are, with no gather."""
    from repro_torch.launch.steps import abstract_cell
    cfg = get_config("command-r-35b")
    rec = dryrun.run_cell("command-r-35b", "decode_32k", False)
    mesh = production_abstract_mesh()
    cell = abstract_cell(cfg, "decode_32k", mesh)
    want = sum(math.prod(sh.local_shape(t.shape, sh.leaf_at(specs, path),
                                        mesh)) * t.element_size()
               for arg, specs in zip(cell.args, cell.in_pspecs)
               for path, t in sh.flatten(arg) if isinstance(t, torch.Tensor))
    assert rec["ok"] and rec["kind"] == "decode"
    assert rec["memory"]["argument_bytes"] == want
    Lc, D, bl = cfg.num_layers, cfg.d_model, 128 // 16
    coll = rec["collective_bytes_per_chip"]
    assert coll["all-reduce"] == (2 * Lc + 1) * bl * D * 2
    assert coll["all-gather"] == 2 * Lc * bl * cfg.kv_dim * 2
    assert rec["memory"]["output_bytes"] >= bl * cfg.vocab_size // 16 * 4
    assert rec["cost"]["flops"] > 2 * 2 * cfg.param_count() / 16 * bl / 2


def test_dryrun_records_refused_cells(tmp_path):
    """The wide-TP decode cell of command-r-plus-104b (96 heads over 256
    ranks) and a MoE model's train cell are written ``ok: false`` with
    the reason; the dense prefill cell runs."""
    rc = dryrun.main(["--arch", "command-r-plus-104b", "--shape",
                      "prefill_32k,decode_32k", "--mesh", "single",
                      "--out", str(tmp_path)])
    assert rc == 1
    assert dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 1
    recs = {p.name.split("__")[1]: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert recs["prefill_32k"]["ok"]
    assert not recs["decode_32k"]["ok"]
    assert "cuts a head" in recs["decode_32k"]["error"]
    assert not recs["train_4k"]["ok"]
    assert recs["train_4k"]["error"].startswith("NotImplementedError")
    assert "moe family" in recs["train_4k"]["error"]


# --- the dry run's train cells -----------------------------------------------------

DENSE = ["olmo-1b", "codeqwen1.5-7b", "command-r-35b", "command-r-plus-104b"]


def _local_bytes(tree, specs, mesh, *, fsdp: bool = False,
                 gathered: bool = False) -> int:
    """The bytes of a tree's ``meta`` leaves sliced as ``specs`` say;
    with ``fsdp``, of the FSDP leaves alone, and with ``gathered`` too,
    of those whole over data."""
    total = 0
    for path, t in sh.flatten(tree):
        if not (isinstance(t, torch.Tensor) and t.is_meta):
            continue
        spec = sh.leaf_at(specs, path)
        d = sh.fsdp_dim(spec)
        if (fsdp or gathered) and d is None:
            continue
        shape = list(sh.local_shape(t.shape, spec, mesh))
        if gathered:
            shape[d] *= mesh.shape["data"]
        total += math.prod(shape) * t.element_size()
    return total


def _fsdp_leaves(params, specs):
    return {"/".join(p): sh.leaf_at(specs, p) for p, _ in sh.flatten(params)
            if sh.fsdp_dim(sh.leaf_at(specs, p)) is not None}


def _fsdp_uses(cfg, path: str) -> tuple[int, int]:
    """(gathers, reduce-scatters) of one FSDP leaf a microbatch: a
    block's leaf is gathered inside its remat block, in the forward and
    again in the backward's recompute, and its gradient reduce-scattered
    once (the recompute's graph is not differentiated); the tied embed
    at its two uses (the lookup and the head), each differentiated."""
    if path.startswith("blocks/"):
        return 2, 1
    return (2, 2) if path == "embed" and cfg.tie_embeddings else (1, 1)


def _fsdp_bytes(cfg, params, specs, mesh) -> tuple[int, int]:
    """(all-gather, reduce-scatter) bytes of the FSDP leaves a
    microbatch: each gathered whole over data in bf16 at each use, its
    f32 gradient reduce-scattered to the rank's slice."""
    gathers = scatters = 0
    for name, spec in _fsdp_leaves(params, specs).items():
        t = sh.leaf_at(params, name.split("/"))
        local = math.prod(sh.local_shape(t.shape, spec, mesh))
        g, r = _fsdp_uses(cfg, name)
        gathers += g * local * mesh.shape["data"] * 2
        scatters += r * local * 4
    return gathers, scatters


def _train_cell_cut(arch, multi, monkeypatch, layers: int):
    """(cell, record) of ``arch``'s train_4k cell cut to ``layers``
    layers, with the full config's FSDP groups and microbatches."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps
    full = get_config(arch)
    plan = steps.plan_residency
    monkeypatch.setattr(steps, "plan_residency",
                        lambda cfg, **kw: plan(full, **kw))
    mesh = production_abstract_mesh(multi_pod=multi)
    return dryrun.trace_cell(
        dataclasses.replace(full, num_layers=layers), "train_4k", multi,
        microbatches=steps.default_microbatches(full, SHAPES["train_4k"],
                                                mesh))


@pytest.mark.parametrize("multi", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", DENSE)
def test_dryrun_train_cells_trace(arch, multi, monkeypatch):
    """Every dense arch's train_4k cell traces on the (16, 16) and the
    (2, 16, 16) mesh: forward, backward and AdamW on rank 0's shards.
    command-r-plus-104b's pod cell at full depth, as the dry run writes
    it (``run_cell``), and its record the 2-layer cut's plus 62 times a
    layer's (the 2-layer less the 1-layer cut: every layer is the same
    work); the others cut to 2 layers with the full config's FSDP groups
    and microbatches. Its argument bytes are the local f32 params, m, v
    and the batch; its FLOPs at least the block products' 8 a parameter
    a token (forward, remat forward, backward) but w_down's 6 (the
    non-reentrant checkpoint stops its recompute once every tensor the
    backward saves is back, before the block's last product); the
    gradients' all-reduce at least their bytes; the planner's FSDP
    groups (command-r-plus-104b's embed and ffn) gathered in bf16 at
    each use and reduce-scattered in f32 (``_fsdp_uses``)."""
    full = arch == "command-r-plus-104b" and not multi
    if full:
        mesh = production_abstract_mesh()
        cfg = get_config(arch)
        one, two = (_train_cell_cut(arch, multi, monkeypatch, n)[1]
                    for n in (1, 2))
        cell, rec = dryrun.trace_cell(cfg, "train_4k", multi)
        grow = cfg.num_layers - 2
        assert rec["cost"]["flops"] == two["cost"]["flops"] + grow * (
            two["cost"]["flops"] - one["cost"]["flops"])
        for kind, n in rec["collective_bytes_per_chip"].items():
            per = two["collective_bytes_per_chip"][kind] - \
                one["collective_bytes_per_chip"][kind]
            assert n == two["collective_bytes_per_chip"][kind] + grow * per
    else:
        cell, rec = _train_cell_cut(arch, multi, monkeypatch, 2)
        cfg, mesh = cell.cfg, production_abstract_mesh(multi_pod=multi)
    assert rec["ok"] and rec["kind"] == "train", rec
    params, opt, batch = cell.args
    p_spec, o_spec, b_spec = cell.in_pspecs
    p_bytes = _local_bytes(params, p_spec, mesh)
    parts = rec["memory"]["argument_parts_bytes"]
    assert parts == {"params": p_bytes, "m": p_bytes, "v": p_bytes,
                     "batch": _local_bytes(batch, b_spec, mesh)}
    assert rec["memory"]["argument_bytes"] == sum(parts.values())
    tp, dp = mesh.shape["model"], mesh.size // mesh.shape["model"]
    tokens = 256 // dp * 4096
    blocks = cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model
    w_down = cfg.num_layers * cfg.d_ff * cfg.d_model
    assert rec["cost"]["flops"] >= (8 * blocks - 2 * w_down) / tp * tokens
    coll = rec["collective_bytes_per_chip"]
    fsdp = _fsdp_leaves(params, p_spec)
    grads = p_bytes - _local_bytes(params, p_spec, mesh, fsdp=True)
    assert coll["all-reduce"] >= grads
    if arch == "command-r-plus-104b":
        assert {k.split("/")[-1] for k in fsdp} == \
            {"embed", "w_gate", "w_up", "w_down"}
    mb = 8 if get_config(arch).param_count() > 3e10 else 4
    gathers, scatters = _fsdp_bytes(cfg, params, p_spec, mesh)
    assert coll["all-gather"] >= mb * gathers
    assert coll["reduce-scatter"] >= mb * scatters
    if not fsdp and cfg.num_kv_heads % tp == 0:
        assert coll["all-gather"] == coll["reduce-scatter"] == 0


@pytest.mark.parametrize("arch", ["olmo-1b", "codeqwen1.5-7b"])
def test_dryrun_train_all_reduce_is_the_gradients_and_two_scalars(arch):
    """A reduced config's train_4k cell at (data, model) = (2, 1): no
    tensor parallelism, no FSDP (the planner streams nothing), so the
    step's collectives are one all-reduce of each f32 gradient over data
    and two of a f32 scalar (the clip's squared norm and the loss)."""
    from repro_torch.launch.steps import abstract_cell, lower_cell
    cfg = get_config(arch).reduced()
    mesh = AbstractMesh((2, 1), ("data", "model"))
    cell = abstract_cell(cfg, "train_4k", mesh)
    params, p_spec = cell.args[0], cell.in_pspecs[0]
    assert not _fsdp_leaves(params, p_spec)
    low = lower_cell(cell, mesh)
    grads = sum(t.numel() * 4 for _, t in sh.flatten(params))
    assert low.collective_bytes == {
        "all-gather": 0, "all-reduce": grads + 2 * 4, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}


@pytest.mark.parametrize("arch", ["olmo-1b", "codeqwen1.5-7b"])
def test_dryrun_train_fsdp_gathers_once_a_microbatch(arch, monkeypatch):
    """A reduced config's train_4k cell at (2, 2) with every residency
    group streamed (the planner made to stream them): each microbatch,
    each FSDP leaf's f32 slice is cast to bf16 and gathered whole over
    data at each of its uses (``layers.fsdp_leaf``: a block's leaves
    once in the forward and once more in the remat recompute, the tied
    embed at the lookup and the head), and each differentiated use
    reduce-scatters its f32 gradient back; at tp 2 the reduced configs'
    KV heads split whole, so no tensor-parallel gather adds to either."""
    from types import SimpleNamespace

    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import _GROUP_PATTERNS
    cfg = get_config(arch).reduced()
    mesh = AbstractMesh((2, 2), ("data", "model"))
    monkeypatch.setattr(steps, "plan_residency", lambda *a, **kw:
                        SimpleNamespace(streamed=frozenset(_GROUP_PATTERNS)))
    cell = steps.abstract_cell(cfg, "train_4k", mesh)
    params, p_spec = cell.args[0], cell.in_pspecs[0]
    fsdp = _fsdp_leaves(params, p_spec)
    assert {"blocks/wq", "blocks/w_down", "embed"} <= set(fsdp)
    mb = steps.default_microbatches(cfg, SHAPES["train_4k"], mesh)
    gathers, scatters = _fsdp_bytes(cfg, params, p_spec, mesh)
    low = steps.lower_cell(cell, mesh)
    assert low.collective_bytes["all-gather"] == mb * gathers
    assert low.collective_bytes["reduce-scatter"] == mb * scatters


def _meta_case(name, device):
    """(wrapper, args, kwargs) of one kernel wrapper at a small shape,
    every key and row live, on ``device``."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16) \
            .to(device)

    def n(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)
    if name == "flash":
        return ops.flash_attention, (r(2, 9, 4, 8), r(2, 13, 2, 8),
                                     r(2, 13, 2, 8)), {"causal": False}
    if name == "decode":
        return ops.decode_attention, (r(2, 4, 8), r(2, 13, 2, 8),
                                      r(2, 13, 2, 8), n((2,), 13)), {}
    if name == "paged":
        table = torch.arange(1, 7, dtype=torch.int32).view(2, 3).to(device)
        return ops.paged_decode_attention, (r(2, 4, 8), r(2, 7, 4, 8),
                                            r(2, 7, 4, 8), table,
                                            n((2,), 12)), {}
    return ops.grouped_mvm, (r(3, 5, 8), r(3, 8, 6)), {}


@pytest.mark.parametrize("name", ["flash", "decode", "paged", "grouped"])
def test_meta_kernels_take_the_plain_shapes_and_flops(name):
    """On ``meta`` each kernel wrapper returns its plain version's shape
    and dtype, and FlopCounterMode counts the plain version's FLOPs for
    it (every key and row live); a causal flash call counts its visible
    pairs only."""
    from torch.utils.flop_counter import FlopCounterMode
    seen = {}
    for device in ("cpu", "meta"):
        fn, args, kw = _meta_case(name, device)
        with FlopCounterMode(display=False) as fc:
            out = fn(*args, **kw)
        seen[device] = (tuple(out.shape), out.dtype, fc.get_total_flops())
    assert seen["meta"] == seen["cpu"]
    if name == "flash":
        fn, (q, k, v), _ = _meta_case(name, "meta")
        with FlopCounterMode(display=False) as fc:
            fn(q[:, :5], k[:, :5], v[:, :5], causal=True)
        assert fc.get_total_flops() == 4 * 2 * 4 * 8 * (5 * 6 // 2)
