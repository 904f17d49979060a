"""The mesh slice for the vlm, ssm, hybrid and encoder-decoder families on
the CPU: meshes of 2 and 4 ranks as processes over ``gloo``
(``_torch_mesh_worker.py``), held against the port at one rank and the
reference on the same converted weights.

Reduced qwen2-vl-7b (vlm: M-RoPE, a column-parallel ``patch_proj``),
rwkv6-7b (ssm), recurrentgemma-9b (hybrid: MQA over one KV head, stored
e times under tensor parallelism) and whisper-tiny (encoder-decoder,
static) at meshes (data, model) (1, 2), (2, 2) and (1, 4); at (1, 4)
reduced whisper-tiny's 2 KV heads are cut (it stores no expanded heads,
as the reference accepts and ignores ``kv_expand``), so it serves at (1,
2) and (2, 2) and raises "cuts a head" at (1, 4). One launch a mesh
holds every family's tasks.

Checks, a family at a time:
- the sharded draw is the one-rank draw's slices, bit for bit;
- f32 (both compute dtypes of the port set to f32 in the task, the
  params the f32 masters): the prefill's and 8 teacher-forced decode
  steps' logits within 1e-4 (rtol and atol) of the one-rank port's,
  the same bits on every rank, and the state after them (the WKV
  matrices and token-shift registers, the RG-LRU hidden and conv
  register, the caches) gathered whole within 1e-4 of one rank's;
- bf16 (as the port serves): the sharded prefill's and first decode
  step's logits within ``TOL_BF16`` (4e-2) of the reference's on one
  device, the tolerance ``test_torch_mesh.py`` holds the dense family's
  TP logits to and ``test_torch_rwkv6.py`` rwkv6's one decode step;
- the engine at (1, 2) (vlm, ssm, hybrid, bf16, greedy, fused horizons
  of 4): one rank's ledger exactly (admission and done steps, pages,
  dispatches, syncs), the byte counts a rank's share of the state (the
  hybrid's pages hold the rank's one expanded head, as one rank's hold
  the one KV head), the same tokens on every rank and the same token
  counts as one rank, each differing stream greedy-consistent with the
  reference (``_torch_parity.GREEDY_GAP``);
- whisper-tiny with a vocabulary of 257 (odd: the rule table leaves its
  tied embedding whole, so the head gives the whole vocabulary) served
  by ``launch.serve``'s static mode with temperature sampling at (1, 2):
  the tokens of one rank, every id in the vocabulary;
- one f32 train step (lr 1e-3, remat) under DP (2, 1), TP (1, 2) and
  (1, 4), DP x TP (2, 2) and FSDP (2, 2) with every residency group
  streamed: the loss and gradient norm, the same on every rank, and
  every param leaf after the step within 1e-4 relative (Frobenius) of
  the one-rank port's (``test_torch_mesh_train.py``'s bound), qwen2-vl's
  key bias within the whole tree's bound alone.

The dry run's cells of these families are ``test_torch_dryrun_families.py``.

Every multi-rank run joins a file store under a temporary directory with
a 60 s timeout, one torch thread a rank, and is killed and failed at its
deadline: a dead rank cannot hang the suite.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import compute_dtype
from _torch_parity import GREEDY_GAP, greedy_gap, ledger, setup, train_batch
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import get_model
from repro_torch.models.layers import serve_kv_expand
from repro_torch.runtime import Engine, EngineConfig
from test_torch_mesh import CPU, engine_trace, launched
from test_torch_mesh import _inputs as _tokens

FAMILIES = ["qwen2-vl-7b", "rwkv6-7b", "recurrentgemma-9b", "whisper-tiny"]
ENGINE = ["qwen2-vl-7b", "rwkv6-7b", "recurrentgemma-9b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
#: train case -> (mesh, its settings)
TRAIN = {"(2, 1)": ((2, 1), {}), "(1, 2)": ((1, 2), {}),
         "(1, 4)": ((1, 4), {}), "(2, 2)": ((2, 2), {}),
         "(2, 2) fsdp": ((2, 2), {"fsdp": True})}
B, S, CACHE, STEPS = 4, 8, 16, 8
TOL32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
# the hybrid's whole-prompt logits against the reference:
# test_torch_hybrid.py's TOL_SEQ (the reference's own compiled and
# op-by-op forwards differ by up to 0.060 there)
TOL_SEQ = dict(rtol=8e-2, atol=8e-2)
ENGINE_CFG = dict(num_slots=3, page_size=8, num_pages=25,
                  max_pages_per_seq=4, prefill_bucket=8, greedy=True,
                  horizon=4)


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


def _cuts_a_head(cfg, tp: int) -> bool:
    """Whisper stores whole KV heads only: a model axis that does not
    divide its heads cuts one."""
    return cfg.family == "encdec" and bool(
        cfg.num_heads % tp or cfg.num_kv_heads % tp)


def _inputs(cfg):
    """The static path's tokens (B, S), teacher tokens (B, STEPS) and the
    family's extras, from numpy seeds."""
    rng = np.random.default_rng(1)
    tokens, teacher = _tokens(cfg, rng)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return tokens, teacher, extras


def _train_case(arch, name, **kw) -> dict:
    _, jp, cfg, _, _ = _models(arch)
    return {"name": name, "params": jax.tree.map(np.asarray, jp),
            "batches": [train_batch(cfg, B, 16, seed=10)], "f32": True,
            "steps": 1, **kw}


#: whisper-tiny reduced, its vocabulary odd: (key, arch, fields)
ODD_VOCAB = ("whisper-tiny/v257", "whisper-tiny", {"vocab_size": 257})
SAMPLED = ["--arch", "whisper-tiny", "--mode", "static", "--temperature",
           "1.0", "--seed", "5", *CPU]


def _launched(mesh, factory) -> list[dict]:
    return launched("families", mesh, factory, _family_tasks)


def _family_tasks(mesh):
    """Every family's tasks in one launch of a mesh: the draw (seed 3),
    the f32 static run with its state and, where the heads divide, the
    bf16 one; at (1, 2) the engine and the sampled odd vocabulary; the
    train cases of the mesh; at (2, 2) the one-rank train baseline (rank
    0 alone); at (1, 4) whisper's refusal."""
    archs = {}
    for arch in FAMILIES:
        _, _, cfg, params, master = _models(arch)
        tokens, teacher, extras = _inputs(cfg)
        tasks = archs[arch] = [] if mesh == (2, 1) else [("draw", 3)]
        if mesh == (1, 4) and _cuts_a_head(cfg, 4):
            tasks.append(("refuse", [["--arch", arch, "--mode", "static",
                                       *CPU]]))
        elif mesh != (2, 1):
            tasks += [
                ("static", master, torch.as_tensor(tokens),
                 torch.as_tensor(teacher), CACHE,
                 {"f32": True, "state": True, "extras": extras}),
                ("static", params, torch.as_tensor(tokens),
                 torch.as_tensor(teacher[:, :1]), CACHE,
                 {"name": "bf16", "extras": extras})]
        if mesh == (1, 2) and arch in ENGINE:
            tasks.append(("engine", params, engine_trace(cfg), ENGINE_CFG))
        if mesh == (2, 2):
            tasks.append(("train", _train_case(arch, "solo", solo=True)))
        for name, (m, kw) in TRAIN.items():
            if m == mesh and not _cuts_a_head(cfg, mesh[1]):
                tasks.append(("train", _train_case(arch, name, **kw)))
    configs = {}
    if mesh == (1, 2):
        key, arch, fields = ODD_VOCAB
        archs[key] = [("sample", SAMPLED, {"f32": True})]
        configs[key] = (arch, fields)
    return archs, configs


def _ranks(mesh, factory, arch) -> list[dict]:
    return [{"coords": r["coords"], **r[arch]}
            for r in _launched(mesh, factory)]


# --- serving ----------------------------------------------------------------------


@functools.cache
def _one_rank_f32(arch, e: int):
    """The one-rank port in f32: the prefill's and each teacher-forced
    decode step's logits, and the state after them, its caches' KV heads
    stored ``e`` times as the sharded run's are."""
    _, _, cfg, _, master = _models(arch)
    api = get_model(cfg)
    tokens, teacher, extras = _inputs(cfg)
    batch = {k: torch.as_tensor(v) for k, v in
             {"tokens": tokens, **extras}.items()}
    with compute_dtype(True), torch.no_grad():
        logits, state = api.prefill(cfg, master, batch, CACHE, kv_expand=e)
        out = [logits]
        for j in range(STEPS):
            logits, state = api.decode_step(cfg, master, state,
                                            torch.as_tensor(teacher[:, j]))
            out.append(logits)
    return torch.stack(out).numpy(), state


@functools.cache
def _reference_bf16(arch):
    """The reference's prefill and first decode step logits on one
    device."""
    jcfg, jp, cfg, _, _ = _models(arch)
    api = jget_model(jcfg)
    tokens, teacher, extras = _inputs(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             {"tokens": tokens, **extras}.items()}
    logits, state = api.prefill(jcfg, jp, batch, CACHE)
    nxt, _ = api.decode_step(jcfg, jp, state, jnp.asarray(teacher[:, 0]))
    return np.stack([np.asarray(logits, np.float32),
                     np.asarray(nxt, np.float32)])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_draw_is_the_one_rank_draw(arch, mesh, tmp_path_factory):
    """Every rank's ``init_params(local=)`` draw is its slices of the
    one-rank draw, bit for bit, and holds less than the whole model."""
    _, _, cfg, _, _ = _models(arch)
    api = get_model(cfg)
    whole = api.init_params(cfg, 3, device="cpu")
    abstract = AbstractMesh(mesh, ("data", "model"))
    specs = sh.param_pspecs(whole, abstract)
    for r in _ranks(mesh, tmp_path_factory, arch):
        abstract.coords = r["coords"]
        want = dict(sh.flatten(sh.shard_tree(whole, specs, abstract)))
        got = dict(sh.flatten(r["draw"]))
        assert got.keys() == want.keys()
        for path, t in want.items():
            assert torch.equal(got[path], t), (r["coords"], path)
        assert sum(t.numel() for t in got.values()) < \
            sum(t.numel() for _, t in sh.flatten(whole))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_serving_matches_one_rank_in_f32(arch, mesh,
                                                 tmp_path_factory):
    """f32: the sharded prefill and 8 teacher-forced decode steps give
    the one-rank logits within 1e-4, the same bits on every rank, and
    the state after them, gathered whole, within 1e-4 of one rank's.
    Whisper at (1, 4), whose split cuts a KV head, raises by name
    instead."""
    _, _, cfg, _, _ = _models(arch)
    ranks = _ranks(mesh, tmp_path_factory, arch)
    if _cuts_a_head(cfg, mesh[1]):
        for r in ranks:
            (msg,) = r["refuse"]
            assert msg is not None and "cuts a head" in msg, msg
        return
    one, state = _one_rank_f32(arch, serve_kv_expand(cfg, mesh[1]))
    got = ranks[0]["static"]
    for r in ranks[1:]:
        assert torch.equal(r["static"]["logits"], got["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), one, **TOL32)
    seen = 0
    for path, want in sh.flatten(state):
        if isinstance(want, torch.Tensor):
            mine = sh.leaf_at(got["state"], path)
            assert mine.shape == want.shape, (path, mine.shape, want.shape)
            np.testing.assert_allclose(mine.float().numpy(),
                                       want.float().numpy(), **TOL32,
                                       err_msg="/".join(path))
            seen += 1
    assert seen >= 2


SERVED = [(arch, mesh) for arch in FAMILIES for mesh in MESHES
          if not _cuts_a_head(get_config(arch).reduced(), mesh[1])]


@pytest.mark.parametrize("arch,mesh", SERVED, ids=str)
def test_sharded_serving_follows_the_reference_in_bf16(arch, mesh,
                                                       tmp_path_factory):
    """bf16: the sharded prefill's and first decode step's logits within
    4e-2 of the reference's on one device (the hybrid's within its 8e-2
    of a whole prompt), the same bits on every rank."""
    ranks = _ranks(mesh, tmp_path_factory, arch)
    got = ranks[0]["bf16"]["logits"]
    for r in ranks[1:]:
        assert torch.equal(r["bf16"]["logits"], got)
    np.testing.assert_allclose(
        got.float().numpy(), _reference_bf16(arch),
        **(TOL_SEQ if arch == "recurrentgemma-9b" else TOL_BF16))


def _share(cfg, want: dict) -> dict:
    """The byte fields of one rank's engine report at (1, 2) from the
    one-rank report's: the recurrent state a rank's share (its heads, its
    channels, its register slices; whisper's and rwkv6's int position is
    4 bytes on every rank), the pages a rank's cache heads'."""
    tp = 2
    heads = cfg.num_kv_heads * (2 if cfg.family == "hybrid" else 1) // tp
    page = want["page_bytes"] * heads // max(cfg.num_kv_heads, 1)
    if cfg.family == "ssm":
        slot = (want["slot_state_bytes"] - 4) // tp + 4
        return {"page_bytes": 0, "slot_state_bytes": slot,
                "cache_bytes_alloc": slot, "kv_bytes_peak": slot}
    slot = want["slot_state_bytes"] // tp
    pool = want["cache_bytes_alloc"] - want["slot_state_bytes"]
    return {"page_bytes": page, "slot_state_bytes": slot,
            "cache_bytes_alloc": pool * heads // cfg.num_kv_heads + slot,
            "kv_bytes_peak": want["peak_live_pages"] * page + slot}


@pytest.mark.parametrize("arch", ENGINE)
def test_sharded_engine_gives_one_rank_ledger(arch, tmp_path_factory):
    """The engine at (1, 2) on a seeded 6-request trace: one rank's
    ledger exactly but the byte counts, which are a rank's share; the
    same tokens on every rank, one rank's token counts, and each stream
    that differs from one rank's greedy-consistent with the
    reference."""
    jcfg, jp, cfg, params, _ = _models(arch)
    ranks = _ranks((1, 2), tmp_path_factory, arch)
    rep = Engine(cfg, params, EngineConfig(**ENGINE_CFG)).run(
        copy.deepcopy(engine_trace(cfg)))
    want, got = ledger(rep), ledger(ranks[0]["engine"])
    share = _share(cfg, want)
    for f, n in share.items():
        assert got.pop(f) == n, (f, n)
        want.pop(f)
    assert got == want
    toks = [{r.rid: r.generated for r in rk["engine"].completed}
            for rk in ranks]
    assert toks[0] == toks[1]
    mine = {r.rid: r for r in ranks[0]["engine"].completed}
    for r in rep.completed:
        assert len(mine[r.rid].generated) == len(r.generated)
        if mine[r.rid].generated != r.generated:
            gap = greedy_gap(jcfg, jp, mine[r.rid])
            assert gap <= GREEDY_GAP, (r.rid, gap)


def test_sampling_over_an_odd_vocabulary_matches_one_rank(
        tmp_path_factory):
    """Reduced whisper-tiny with 257 vocabulary rows, which the model
    axis of (1, 2) does not divide, so its tied embedding stays whole and
    every rank's head gives the whole vocabulary: ``launch.serve``'s
    static mode, sampling at temperature 1 in f32, draws one rank's
    tokens on every rank, each id inside the vocabulary."""
    key, arch, fields = ODD_VOCAB
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    args = serve.parse_args(SAMPLED)
    with compute_dtype(True), torch.no_grad():
        one = serve.static_decode(cfg, serve.init_params(cfg, args), args)[0]
    ranks = _launched((1, 2), tmp_path_factory)
    assert one.shape == (args.batch, args.gen) and one.max() < 257
    assert len(set(one.ravel().tolist())) > 1       # sampled, not stuck
    for r in ranks:
        np.testing.assert_array_equal(r[key]["sample"], one)


# --- training ---------------------------------------------------------------------

TRAINED = [(arch, name) for arch in FAMILIES for name, (m, _) in
           TRAIN.items() if not _cuts_a_head(get_config(arch).reduced(),
                                             m[1])]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch,name", TRAINED, ids=str)
def test_f32_sharded_train_step_matches_one_rank(arch, name,
                                                 tmp_path_factory):
    """One f32 step (lr 1e-3, remat) on the mesh against the one-rank
    port's: the loss and gradient norm the same on every rank and within
    1e-4 of one rank's, every param leaf after the step within 1e-4
    relative of one rank's and the whole tree too. qwen2-vl's key bias
    ``bk`` is held within the total alone, as
    ``test_torch_mesh_train.py`` holds the dense family's: softmax is
    nearly invariant to it, so some elements of its gradient are at the
    f32 rounding of their sum, and Adam's first step moves each such
    element by +-lr whichever way its rounding goes."""
    mesh = TRAIN[name][0]
    ranks = [r[name] for r in _ranks(mesh, tmp_path_factory, arch)]
    one = _ranks((2, 2), tmp_path_factory, arch)[0]["solo"]
    got = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == got["loss"] and \
            r["grad_norm"] == got["grad_norm"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                               rtol=1e-4)
    mine, want = dict(sh.flatten(got["params"])), \
        dict(sh.flatten(one["params"]))
    assert mine.keys() == want.keys()
    errs = {"/".join(k): _rel(mine[k].numpy(), v.numpy())
            for k, v in want.items() if v.numel()}
    errs.pop("blocks/bk", None)         # held within the total (below)
    assert max(errs.values()) <= 1e-4, errs
    order = sorted(want)
    assert _rel(np.concatenate([mine[k].numpy().ravel() for k in order]),
                np.concatenate([want[k].numpy().ravel() for k in order])
                ) <= 1e-4
