"""The port's sharded training on the CPU: meshes of 2 and 4 ranks as
processes over ``gloo`` (``_torch_mesh_worker.py``: tasks "train",
"ckpt", "fault", "entry", "refuse_train"), held against the port at one
rank and the reference on one device, from the same converted weights.

Reduced ``olmo-1b`` (tied embeddings, non-parametric LayerNorm) and
reduced ``codeqwen1.5-7b`` (QKV biases: the ``chan`` rule), weights from
the reference's ``init_params`` through ``convert.params_from_jax(
master=True)``, batches of 4 x 16 tokens from numpy seeds. Meshes
(data, model): (2, 1), (1, 2), (1, 4) (2 KV heads expanded to 4 and
wk/wv cut within a head: the gathered weight's gradient is reduce-
scattered), (2, 2), (2, 2) with every residency group streamed (FSDP
over data), (2, 2) with 2 microbatches, and (pod, data, model) =
(2, 1, 2).

Checks:
- (a) f32 (both compute dtypes of the port set to f32 inside the
  worker): three AdamW steps (lr 1e-3, warmup 2, remat). Each step's
  loss and gradient norm, the first moment after step 1 (0.1 x the
  clipped gradient) of every leaf, and every param leaf after step 3,
  gathered whole, within 1e-4 relative (Frobenius) of the one-rank port
  in f32: the f32 ``TOL`` of ``tests/test_kernels.py:18``. The largest
  errors found: losses 8.6e-8, gradient norms 5.5e-7, first moments
  9.2e-7, params 4.7e-6 (w_down at (1, 4)), the total 1.7e-6. One leaf
  is held within the total over all leaves
  instead: the key bias ``bk`` after step 3. Softmax is nearly invariant
  to it (only RoPE's rotation of k + bk tells its directions apart), so
  some of its gradient's elements are at the f32 rounding of the sum
  (about 1e-9), and Adam's first steps, which normalise each element by
  its own size, move such an element by +-lr whichever way its rounding
  goes. The one-rank port does it against itself: its bk after three
  steps with 2 microbatches is 1.1e-3 off its bk with one
  (``test_one_rank_microbatches_match_one_batch_in_f32``); the sharded
  runs' bk is 2.6e-3 off at most.
- (b) bf16 (as the port trains): the step-1 loss within 2e-2 of the
  reference's ``make_train_step`` on one device, and each leaf's first
  moment after step 1 within ``tests/test_torch_train.py``'s gradient
  rule of the reference's: 2e-2, or twice the reference's own spread
  (its compiled against its op-by-op gradients) where that is larger,
  never above 5e-2 (olmo-1b 0.026, codeqwen1.5-7b 0.044). The bf16
  row-parallel partial sums are rounded before the sum
  (``test_torch_mesh.py``), so the bf16 runs follow the rule and only
  the f32 runs prove the formulas. The largest errors found: losses
  4.0e-4, first moments 0.017 (olmo-1b) and 0.025 (codeqwen1.5-7b).
- (c) A checkpoint saved at step 2 on (2, 2) has the one-device key set,
  shapes and dtypes, and its save held one whole leaf at a time on the
  host (rank 0 writes each before the next gather, the other ranks keep
  none); resumed on one rank and on (1, 2), step 3 there equals (2, 2)'s
  step 3 within the f32 tolerance. The reverse: the one-rank run's
  step-2 checkpoint resumed on (2, 2) gives the one-rank step 3. The
  entry point (``launch.train.train``, f32) on (2, 2), called twice on
  one directory so that the second call resumes, gives one rank's
  losses within 1e-4 (8.6e-8 found).
- (d) A ``kill@2`` fault on (2, 2) with a checkpoint every step: every
  rank restores once, from step 2, and the run ends with the params of
  the run without a fault, bit for bit.
- (e) ``launch.train.main --mesh pod`` raises RuntimeError naming 256
  ranks in a world of one; under (1, 2) a non-dense family raises
  NotImplementedError naming it.
- A remat block's recompute runs in its forward's context, on whatever
  thread the backward runs.

One launch a mesh, all of its cases in it; every multi-rank run joins a
file store under a temporary directory with a 60 s timeout, one torch
thread a rank, and is killed and failed at its deadline.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (LOSS_RTOL, flat,  # noqa: E402
                           reference_loss_and_grads, train_batch)
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
ARCHS = ["olmo-1b", "codeqwen1.5-7b"]
B, S, STEPS, SAVE_AT, ENTRY_STEPS = 4, 16, 3, 2, 2
TOL32 = 1e-4
GRAD_REL, GRAD_REL_CAP = 2e-2, 5e-2
DEADLINE = 120.0
DD, DM = ("data", "model"), ("pod", "data", "model")
#: case name -> (mesh shape, axes, the case's settings)
CASES = {
    "(2, 1)": ((2, 1), DD, {}),
    "(1, 2)": ((1, 2), DD, {}),
    "(1, 4)": ((1, 4), DD, {}),
    "(2, 2)": ((2, 2), DD, {}),
    "(2, 2) fsdp": ((2, 2), DD, {"fsdp": True}),
    "(2, 2) microbatches 2": ((2, 2), DD, {"microbatches": 2}),
    "(2, 1, 2)": ((2, 1, 2), DM, {}),
}
MESHES = sorted({(shape, axes) for shape, axes, _ in CASES.values()})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _reference(arch):
    """(reference config, its params as numpy, the port's config, the
    batches)."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init_params(
        jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, cfg, [train_batch(cfg, B, S, seed=10 + i)
                           for i in range(STEPS)]


def _case(arch, **kw) -> dict:
    _, jp, _, batches = _reference(arch)
    return {"params": jp, "batches": batches, "f32": True, "steps": STEPS,
            **kw}


def _run(tmp, shape, axes, archs) -> list[dict]:
    """Each rank's results of ``archs`` (arch -> tasks) on the mesh: one
    process a rank, all joined by ``DEADLINE`` or killed and failed."""
    world = int(np.prod(shape))
    job, out = tmp / "job.pt", tmp / "out"
    torch.save({"mesh": shape, "axes": axes, "archs": archs}, job)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "store"),
         str(job), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE)[0].decode()[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{shape}: ranks did not finish in {DEADLINE} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


_LAUNCHED: dict = {}


def _launched(mesh, factory) -> list[dict]:
    """One launch a mesh: its cases in f32 (3 steps) and bf16 (1 step)
    for both archs. (2, 2) also runs the one-rank baselines (rank 0 alone:
    f32 with 1 and 2 microbatches, the first saving its step 2), the
    checkpointed run (its save watched), the one-rank checkpoint resumed,
    the fault run and the entry point twice; (1, 2), launched after it,
    resumes (2, 2)'s checkpoint on one rank and on the mesh, and refuses
    a MoE model; (1, 1) runs the entry point twice alone."""
    if mesh in _LAUNCHED:
        return _LAUNCHED[mesh]
    shape, axes = mesh
    tmp = factory.mktemp("train_mesh")
    if shape == (1, 2):
        ckpt = _launched(((2, 2), DD), factory)[0]["ckpt_dir"]
    archs = {}
    if shape in ((2, 2), (1, 1)):
        archs[ARCHS[0]] = [("entry", {
            "name": "entry", "f32": True, "dir": str(tmp / "entry"),
            "argv": ["--arch", ARCHS[0], "--device", "cpu", "--steps",
                     str(ENTRY_STEPS), "--seq-len", str(S), "--batch",
                     str(B), "--lr", "3e-3", "--ckpt-every",
                     str(ENTRY_STEPS), "--log-every", "1", "--ckpt-dir",
                     str(tmp / "entry")]})]
    for arch in ARCHS if shape != (1, 1) else ():
        tasks = archs.setdefault(arch, [])
        if shape == (2, 2):
            tasks += [
                ("train", _case(arch, name="solo", solo=True,
                                save=(str(tmp / arch / "solo"), SAVE_AT))),
                ("train", _case(arch, name="solo mb2", solo=True,
                                microbatches=2)),
                ("ckpt", _case(arch, name="resume solo",
                               dir=str(tmp / arch / "solo"))),
                ("fault", _case(arch, name="fault", faults="kill@2:train",
                                dir=str(tmp / arch / "fault")))]
        if shape == (1, 2):
            tasks += [("ckpt", _case(arch, name=f"resume {how}",
                                     dir=f"{ckpt}/{arch}/mesh", solo=solo))
                      for how, solo in (("one rank", True), ("mesh", False))]
        for name, (s, a, kw) in CASES.items():
            if (s, a) != mesh:
                continue
            save = {"save": (str(tmp / arch / "mesh"), SAVE_AT),
                    "watch": True} if name == "(2, 2)" else {}
            tasks += [("train", _case(arch, name=name, **kw, **save)),
                      ("train", _case(arch, name=name + " bf16", **kw,
                                      f32=False, steps=1))]
    if shape == (1, 2):
        archs[ARCHS[0]].append(("refuse_train", {"name": "refuse", "argvs": [
            ["--arch", "olmoe-1b-7b", "--device", "cpu", "--steps", "1",
             "--seq-len", "8", "--batch", "2", "--ckpt-dir",
             str(tmp / "moe")]]}))
    _LAUNCHED[mesh] = _run(tmp, shape, axes, archs)
    _LAUNCHED[mesh][0]["ckpt_dir"] = str(tmp)
    return _LAUNCHED[mesh]


def _results(name, factory, arch, suffix="") -> list[dict]:
    shape, axes, _ = CASES[name]
    return [r[arch][name + suffix] for r in _launched((shape, axes),
                                                       factory)]


def _solo(factory, arch, name="solo") -> dict:
    return _launched(((2, 2), DD), factory)[0][arch][name]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaf_errors(got: dict, want: dict) -> dict:
    got, want = flat(got), flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    return {k: _rel(got[k].numpy(), want[k].numpy())
            for k in want if want[k].numel()}


def _total_error(got: dict, want: dict) -> float:
    got, want = flat(got), flat(want)
    return _rel(np.concatenate([got[k].numpy().ravel() for k in sorted(got)]),
                np.concatenate([want[k].numpy().ravel()
                                for k in sorted(got)]))


# --- (a) f32: the formulas -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(CASES))
def test_f32_sharded_steps_match_one_rank(name, arch, tmp_path_factory):
    """Three f32 steps on the mesh against the one-rank port's: the same
    losses and gradient norms on every rank, within 1e-4 of one rank; the
    first moment after step 1 and the params after step 3 within 1e-4 a
    leaf, ``bk``'s params within the total (see the module's
    docstring)."""
    ranks = _results(name, tmp_path_factory, arch)
    one = _solo(tmp_path_factory, arch)
    got = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == got["loss"] and \
            r["grad_norm"] == got["grad_norm"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=TOL32)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                               rtol=TOL32)
    m_err = _leaf_errors(got["m1"], one["m1"])
    assert max(m_err.values()) <= TOL32, m_err
    p_err = _leaf_errors(got["params"], one["params"])
    p_err.pop("blocks/bk", None)
    assert max(p_err.values()) <= TOL32, p_err
    assert _total_error(got["params"], one["params"]) <= TOL32


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_microbatches_match_one_batch_in_f32(arch,
                                                      tmp_path_factory):
    """The one-rank port against itself, 1 and 2 microbatches in f32
    (the same sums in another order): the losses, gradient norms and
    first moments within 1e-4, every param leaf after three steps too
    but ``bk``, held within the total: its near-zero gradient elements
    become full Adam steps either way (1.1e-3 off on codeqwen1.5-7b,
    the reason (a) holds it so)."""
    one = _solo(tmp_path_factory, arch)
    two = _solo(tmp_path_factory, arch, "solo mb2")
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=TOL32)
    np.testing.assert_allclose(two["grad_norm"], one["grad_norm"],
                               rtol=TOL32)
    assert max(_leaf_errors(two["m1"], one["m1"]).values()) <= TOL32
    err = _leaf_errors(two["params"], one["params"])
    err.pop("blocks/bk", None)
    assert max(err.values()) <= TOL32, err
    assert _total_error(two["params"], one["params"]) <= TOL32


# --- (b) bf16: against the reference -------------------------------------------------


@functools.cache
def _reference_step1(arch):
    """The reference's step-1 loss and first moment (compiled, on one
    device), and the bound of (b): twice the spread of its compiled
    against its op-by-op gradients, within [2e-2, 5e-2]."""
    jcfg, jp, _, batches = _reference(arch)
    nb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    step = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3, warmup=2, total=10))
    _, jopt, jm = step(jp, jadamw_init(jp), nb)
    _, g = reference_loss_and_grads(jcfg, jp, batches[0], remat=True)
    _, g_eager = reference_loss_and_grads(jcfg, jp, batches[0], remat=True,
                                          eager=True)
    spread = max(_rel(g_eager[k], g[k]) for k in g if g[k].size)
    m1 = {k: np.asarray(v) for k, v in flat(jopt.m).items()}
    return float(jm["loss"]), m1, min(max(GRAD_REL, 2 * spread),
                                      GRAD_REL_CAP)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_sharded_step_follows_the_reference(name, arch,
                                                 tmp_path_factory):
    """One bf16 step on the mesh: the loss within the bf16 TOL of the
    reference's and every leaf's first moment within the gradient rule;
    the same numbers on every rank."""
    ranks = _results(name, tmp_path_factory, arch, " bf16")
    loss, m1, bound = _reference_step1(arch)
    got = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"][0], loss, rtol=LOSS_RTOL)
    mine = {k: v.numpy() for k, v in flat(got["m1"]).items()}
    assert set(mine) == set(m1)
    errs = {k: _rel(mine[k], m1[k]) for k in m1 if m1[k].size}
    bad = {k: e for k, e in errs.items() if not e <= bound}
    assert not bad, (bound, bad)


# --- (c) checkpoints across meshes ----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_checkpoint_is_the_one_device_layout(arch, tmp_path_factory,
                                                  tmp_path):
    """(2, 2)'s step-2 checkpoint: the one-device save's keys, shapes
    and dtypes, and the step."""
    _, jp, _, _ = _reference(arch)
    mesh_dir = Path(_launched(((2, 2), DD), tmp_path_factory)[0]["ckpt_dir"])
    params = params_from_jax(jp, device="cpu", master=True)
    CheckpointManager(str(tmp_path)).save(SAVE_AT, (params,
                                                    adamw_init(params)))
    seen = []
    for d in (mesh_dir / arch / "mesh", tmp_path):
        meta = json.loads((d / f"step_{SAVE_AT}" / "meta.json").read_text())
        with np.load(d / f"step_{SAVE_AT}" / "arrays.npz") as z:
            seen.append((meta["keys"], meta["dtypes"],
                         {k: (z[k].shape, z[k].dtype) for k in z.files}))
    assert seen[0] == seen[1]
    assert "1/.step" in seen[0][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_save_holds_one_whole_leaf_at_a_time(arch, tmp_path_factory):
    """(2, 2)'s step-2 save gathers every tensor leaf on every rank;
    rank 0 alone keeps a host copy of each and has written and dropped
    it before the next gather begins, the other ranks keep none: the
    host holds one whole leaf at a time."""
    ranks = _launched(((2, 2), DD), tmp_path_factory)
    _, jp, _, _ = _reference(arch)
    # params, m and v, and AdamW's step count (a 0-d tensor)
    n = 3 * len(flat(params_from_jax(jp, device="cpu", master=True))) + 1
    for rank, r in enumerate(ranks):
        watch = r[arch]["(2, 2)"]["save_watch"]
        assert watch == {"leaves": n, "kept": n if rank == 0 else 0,
                         "live": 0}, (rank, watch)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_resume_across_meshes(arch, tmp_path_factory):
    """(2, 2)'s step-2 checkpoint resumed on one rank and on (1, 2): step
    3 there gives (2, 2)'s step 3 within 1e-4 a leaf (``bk`` within the
    total); the one-rank step-2 checkpoint resumed on (2, 2) gives the
    one-rank step 3."""
    mesh3 = _results("(2, 2)", tmp_path_factory, arch)[0]
    resumed = _launched(((1, 2), DD), tmp_path_factory)
    pairs = [(resumed[0][arch]["resume one rank"], mesh3),
             (resumed[0][arch]["resume mesh"], mesh3),
             (_solo(tmp_path_factory, arch, "resume solo"),
              _solo(tmp_path_factory, arch))]
    for got, want in pairs:
        assert got["restored"] == [SAVE_AT]
        np.testing.assert_allclose(got["loss"], want["loss"][SAVE_AT:],
                                   rtol=TOL32)
        err = _leaf_errors(got["params"], want["params"])
        err.pop("blocks/bk", None)
        assert max(err.values()) <= TOL32, err
        assert _total_error(got["params"], want["params"]) <= TOL32
    for r in _launched(((2, 2), DD), tmp_path_factory):
        assert r[arch]["resume solo"]["restored"] == [SAVE_AT]


def test_entry_point_trains_and_resumes_on_the_mesh(tmp_path_factory):
    """``launch.train.train`` in f32 on (2, 2) and on one rank (a 1x1
    mesh), each called twice on one checkpoint directory: the second
    call resumes from the first's last step. Every rank's losses are the
    same, within 1e-4 of one rank's, and both directories hold the two
    calls' checkpoints."""
    one = _launched(((1, 1), DD), tmp_path_factory)[0][ARCHS[0]]["entry"]
    ranks = _launched(((2, 2), DD), tmp_path_factory)
    got = ranks[0][ARCHS[0]]["entry"]
    for r in ranks[1:]:
        assert r[ARCHS[0]]["entry"]["losses"] == got["losses"]
    for run in (one, got):
        assert [len(x) for x in run["losses"]] == [ENTRY_STEPS] * 2
        assert run["steps"] == [ENTRY_STEPS, 2 * ENTRY_STEPS]
    np.testing.assert_allclose(sum(got["losses"], []),
                               sum(one["losses"], []), rtol=TOL32)


# --- (d) faults ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_fault_restores_every_rank_from_one_step(arch, tmp_path_factory):
    """kill@2 on (2, 2), a checkpoint every step: every rank retries once
    and restores from step 2; the final params are the fault-free run's,
    bit for bit."""
    ranks = _launched(((2, 2), DD), tmp_path_factory)
    want = ranks[0][arch]["(2, 2)"]["params"]
    for r in ranks:
        got = r[arch]["fault"]
        assert got["restores"] == got["retries"] == 1
        assert got["restored"] == [2]
        assert got["loss"] == r[arch]["(2, 2)"]["loss"]
    for k, v in flat(ranks[0][arch]["fault"]["params"]).items():
        assert torch.equal(v, flat(want)[k]), k


# --- remat under a mesh -------------------------------------------------------------


def test_remat_recompute_runs_in_the_forward_context():
    """A remat block's recompute runs in the context its forward ran in
    (``layers.checkpointed``), whichever thread the backward runs on: a
    backward started on a thread of its own, as autograd runs a card's
    backward on its device thread, still sees the FSDP split (and the
    shard context) of the forward, so the recompute gathers what the
    forward gathered."""
    import threading

    from repro_torch.models import layers as L
    seen = []

    def block(x):
        seen.append(L._FSDP.get())
        return x.sin()
    x = torch.linspace(-1, 1, 5, requires_grad=True)
    with L.fsdp_split({"blocks/w": 1}):
        y = L.checkpointed(block, x, remat=True).sum()
    thread = threading.Thread(target=y.backward)
    thread.start()
    thread.join()
    assert seen == [{"blocks/w": 1}] * 2
    torch.testing.assert_close(x.grad, torch.cos(x.detach()))


# --- (e) refusals ----------------------------------------------------------------------


def test_train_pod_mesh_needs_its_256_ranks(tmp_path):
    """A production mesh in a world of one raises, naming the ranks it
    needs: no fallback to one rank."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.main(["--mesh", "pod", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_sharded_training_refuses_other_families(tmp_path_factory):
    """Under (1, 2) a MoE model raises NotImplementedError naming its
    family, on every rank."""
    for r in _launched(((1, 2), DD), tmp_path_factory):
        (msg,) = r[ARCHS[0]]["refuse"]
        assert msg is not None and "moe family" in msg, msg
