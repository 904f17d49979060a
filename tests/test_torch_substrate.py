"""The port's training substrate: data pipeline, AdamW, clipping,
compression, checkpoints, the training supervisor and ``launch.train``.

Port twins of ``tests/test_substrate.py`` (the same cases on the port's
modules), plus the optimizer's formulas against the reference's
``adamw_update`` / ``cosine_schedule`` on the same numbers (f32: rtol
1e-6), checkpoints written by one package and restored by the other,
and the training entry point on the CPU. The token stream's bits differ
from the reference's (a Philox generator keyed by (seed, step, row)
against ``jax.random``); its distribution, determinism and shard
invariance are held here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.optim import OptState as JOptState  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (opt_state_from_jax,  # noqa: E402
                                 opt_state_to_numpy, params_from_jax,
                                 tree_to_numpy)
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule,
                               int8_compress, int8_decompress)
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.runtime import (ElasticConfig,  # noqa: E402
                                 FaultSchedule, TrainingSupervisor,
                                 TransientFault)

# --- data pipeline ----------------------------------------------------------------


def test_stream_deterministic_and_restartable():
    s = TokenStream(vocab_size=97, seq_len=32, global_batch=8, seed=1)
    b1, b2 = s.batch(7), s.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert not torch.equal(s.batch(8)["tokens"], b1["tokens"])
    # a new stream object with the same seed: the same data (a restart)
    assert torch.equal(TokenStream(97, 32, 8, seed=1).batch(7)["tokens"],
                       b1["tokens"])
    # labels are next-token-shifted
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_stream_sharding_invariance():
    s = TokenStream(vocab_size=97, seq_len=16, global_batch=8, seed=3)
    full = s.batch(5)["tokens"]
    for n in (1, 2, 4, 8):
        parts = [s.host_batch(5, i, n)["tokens"] for i in range(n)]
        assert torch.equal(torch.cat(parts), full), n


def test_stream_has_structure():
    """Markov runs (repeat probability 0.7) over a zipf-ish unigram: the
    repeat rate and the head of the distribution are the reference's."""
    s = TokenStream(vocab_size=128, seq_len=256, global_batch=16, seed=0)
    toks = s.batch(0)["tokens"]
    rep_rate = float((toks[:, 1:] == toks[:, :-1]).float().mean())
    assert rep_rate > 0.5                     # Markov runs are learnable
    assert 0 <= int(toks.min()) and int(toks.max()) < 128
    # fresh draws follow p(rank) ~ rank^-1.2: token 0 is the commonest
    fresh = toks[:, 1:][toks[:, 1:] != toks[:, :-1]]
    counts = torch.bincount(fresh.long(), minlength=128).float()
    p = torch.arange(1, 129, dtype=torch.float64) ** -1.2
    assert int(counts.argmax()) == 0
    assert abs(float(counts[0] / counts.sum()) - float(p[0] / p.sum())) \
        < 0.1


# --- optimizer -------------------------------------------------------------------

def _quad_params():
    return {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor(0.5)}


def test_adamw_converges_on_quadratic():
    params = _quad_params()
    state = adamw_init(params)
    lr_fn = cosine_schedule(0.1, warmup_steps=5, total_steps=200)

    def loss(p):
        return torch.sum(torch.square(p["w"])) + torch.square(p["b"])

    for _ in range(200):
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        grads = torch.autograd.grad(loss(params), flat)
        params, state, metrics = adamw_update(params, list(grads), state,
                                              lr_fn=lr_fn, weight_decay=0.0)
    assert float(loss(params).detach()) < 1e-2
    assert int(state.step) == 200


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    grads = [torch.full((4,), 1e6)]
    _, _, metrics = adamw_update(params, grads, state,
                                 lr_fn=lambda s: 0.1, max_grad_norm=1.0)
    assert float(metrics["grad_norm"]) > 1e5   # pre-clip norm reported
    g, gn = clip_by_global_norm([torch.full((4,), 3.0), torch.full((9,),
                                                                   4.0)], 1.0)
    assert float(gn) == pytest.approx(float(np.sqrt(4 * 9 + 9 * 16)))
    assert float(torch.linalg.vector_norm(torch.cat(g))) == \
        pytest.approx(1.0, rel=1e-6)


def test_adamw_and_schedule_match_reference():
    """Four AdamW steps on the same params and gradients as the
    reference's ``adamw_update`` (clip, moments, bias correction, weight
    decay, in its order) under the same cosine schedule: params, m, v,
    the step, the pre-clip norm and the learning rate, f32 (rtol
    1e-6)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": {"d": (2, 2)}}

    def tree(fn, sh=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in sh.items()}
    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    gs = [tree(lambda s: (3 * rng.standard_normal(s)).astype(np.float32))
          for _ in range(4)]
    conv = {"j": lambda t: jnp.asarray(t), "t": lambda t: torch.tensor(t)}

    def tmap(fn, t):
        return {k: tmap(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    jp, tp = tmap(conv["j"], p0), tmap(conv["t"], p0)
    jst, tst = jadamw_init(jp), adamw_init(tp)
    jlr, tlr = jcosine(1e-2, 2, 6), cosine_schedule(1e-2, 2, 6)
    for g in gs:
        jp, jst, jm = jadamw_update(jp, tmap(conv["j"], g), jst, lr_fn=jlr)
        tp, tst, tm = adamw_update(tp, leaves(tmap(conv["t"], g)), tst,
                                   lr_fn=tlr)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(tst.step) == int(jst.step) == 4
    for mine, ref in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for a, b in zip(leaves(mine), leaves(tmap(np.asarray, ref))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-8)
    for step in (0, 1, 2, 3, 6, 9):
        assert tlr(step) == pytest.approx(float(jlr(jnp.asarray(step))),
                                          rel=1e-6, abs=1e-12)


def test_int8_compression_unbiased_and_bounded():
    gen = torch.Generator().manual_seed(0)
    g = {"a": torch.randn(512, generator=gen) * 3.0}
    # unbiased: mean over many stochastic roundings approaches g
    acc = torch.zeros(512)
    n = 64
    for _ in range(n):
        q, s = int8_compress(g, gen)
        acc = acc + int8_decompress(q, s)["a"]
    err = float((acc / n - g["a"]).abs().max())
    scale = float(s["a"])
    assert err < 3 * scale                 # within a few quant steps
    q, s = int8_compress(g, gen)
    assert q["a"].dtype == torch.int8
    assert int(q["a"].abs().max()) <= 127
    # the same generator state draws the same bits
    q1, _ = int8_compress(g, torch.Generator().manual_seed(5))
    q2, _ = int8_compress(g, torch.Generator().manual_seed(5))
    assert torch.equal(q1["a"], q2["a"])


# --- checkpoint -------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"m": torch.ones(3)}}
    for step in (10, 20, 30):
        mgr.save(step, tree)
    assert mgr.steps() == [20, 30]             # keep=2 GC'd step 10
    restored, step = mgr.restore(tree)
    assert step == 30
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_checkpoint_restores_every_leaf_bit_for_bit(tmp_path):
    """bf16 (which numpy lacks), f32 specials, int32 0-d steps, an
    ``OptState`` and tuples: the same bits, dtypes and structure."""
    params = {"w": torch.randn(3, 5).to(torch.bfloat16),
              "s": torch.tensor([0.0, -0.0, float("inf"), 1e-40])}
    tree = (params, adamw_init(params))
    tree[1].m["w"] += 1.5
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree, extra={"loss": 1.25})
    like = ({"w": torch.zeros(3, 5, dtype=torch.bfloat16),
             "s": torch.zeros(4)}, adamw_init(params))
    (p, opt), step = mgr.restore(like)
    assert step == 4 and mgr.extra() == {"loss": 1.25}
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"].view(torch.int16),
                       params["w"].view(torch.int16))
    assert torch.equal(p["s"].view(torch.int32),
                       params["s"].view(torch.int32))
    assert opt.step.shape == () and int(opt.step) == 0
    assert torch.equal(opt.m["w"], tree[1].m["w"])
    with open(tmp_path / "step_4" / "meta.json") as f:
        assert "0/w" in f.read()


def test_checkpoint_atomic_under_crash(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    # simulate a crashed save: stale tmp dir must not shadow a valid ckpt
    os.makedirs(tmp_path / "step_2.tmp")
    (tmp_path / "step_2.tmp" / "garbage").write_text("x")
    assert mgr.latest_step() == 1
    restored, step = mgr.restore(tree)
    assert step == 1
    mgr.save(3, tree)                           # also GCs the orphan tmp
    assert not (tmp_path / "step_2.tmp").exists()


def test_checkpoint_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    restored, _ = mgr.restore({"w": torch.zeros(2)}, step=1)
    assert torch.equal(restored["w"], torch.tensor([1.0, 1.0]))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": 0})


def _cross_state(seed=0):
    """The reference's olmo-1b reduced params and an ``OptState`` two
    AdamW steps in (nonzero m, v and step), as numpy."""
    jcfg = jget("olmo-1b").reduced()
    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    jst = jadamw_init(jp)
    for i in range(2):
        g = jax.tree.map(lambda p: jnp.full_like(p, 0.01 * (i + 1)), jp)
        jp, jst, _ = jadamw_update(jp, g, jst, lr_fn=lambda s: 1e-2)
    return jax.tree.map(np.asarray, jp), jst


def _assert_trees_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_opt_state_converts_both_ways():
    jp, jst = _cross_state()
    opt = opt_state_from_jax(jst, device="cpu")
    assert opt.step.dtype == torch.int32 and int(opt.step) == 2
    assert opt.m["blocks"]["wq"].dtype == torch.float32
    step, m, v = opt_state_to_numpy(opt)
    assert step == 2 and step.dtype == np.int32
    _assert_trees_equal(m, jax.tree.map(np.asarray, jst.m))
    _assert_trees_equal(v, jax.tree.map(np.asarray, jst.v))
    _assert_trees_equal(tree_to_numpy(params_from_jax(
        jp, device="cpu", master=True)), jp)


def test_reference_restores_a_port_checkpoint(tmp_path):
    """The port saves (params, OptState) from a reference state; the
    reference's manager restores it into its own tree (the same keys:
    ``0/blocks/wq``, ``1/.m/...``, ``1/.step``) bit for bit."""
    jp, jst = _cross_state()
    params = params_from_jax(jp, device="cpu", master=True)
    CheckpointManager(str(tmp_path)).save(
        7, (params, opt_state_from_jax(jst, device="cpu")))
    like = (jax.tree.map(jnp.zeros_like, jp), jadamw_init(jp))
    (rp, rst), step = jckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert step == 7 and int(rst.step) == 2
    _assert_trees_equal(jax.tree.map(np.asarray, rp), jp)
    _assert_trees_equal(jax.tree.map(np.asarray, rst.m),
                        jax.tree.map(np.asarray, jst.m))
    _assert_trees_equal(jax.tree.map(np.asarray, rst.v),
                        jax.tree.map(np.asarray, jst.v))


def test_port_restores_a_reference_checkpoint(tmp_path):
    """The reference's manager saves its (params, OptState); the port's
    restores it into a port tree of f32 tensors, bit for bit, and a
    state converted back is the reference's again."""
    jp, jst = _cross_state()
    jckpt.CheckpointManager(str(tmp_path)).save(5, (jp, jst))
    with open(tmp_path / "step_5" / "meta.json") as f:
        keys = json.load(f)["keys"]
    assert "1/.step" in keys and "0/blocks/wq" in keys
    blank = params_from_jax(jax.tree.map(np.zeros_like, jp), device="cpu",
                            master=True)
    (params, opt), step = CheckpointManager(str(tmp_path)).restore(
        (blank, adamw_init(blank)))
    assert step == 5 and int(opt.step) == 2
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    _assert_trees_equal(tree_to_numpy(params), jp)
    step, m, v = opt_state_to_numpy(opt)
    back = JOptState(step=jnp.asarray(step), m=m, v=v)
    _assert_trees_equal(jax.tree.map(np.asarray, back.m),
                        jax.tree.map(np.asarray, jst.m))
    _assert_trees_equal(jax.tree.map(np.asarray, back.v),
                        jax.tree.map(np.asarray, jst.v))


# --- fault tolerance ----------------------------------------------------------------

def _counter_step(fail_at=frozenset(), slow_at=frozenset(), clock=None):
    """state = {'x': tensor}; fails once per step in fail_at."""
    failed = set()

    def step_fn(state, batch):
        s = int(state["x"])
        if s in fail_at and s not in failed:
            failed.add(s)
            raise RuntimeError(f"injected fault at {s}")
        if clock is not None:
            clock.advance(1.0 if s not in slow_at else 10.0)
        return {"x": state["x"] + 1}, {"loss": float(100 - s)}

    return step_fn


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _x0():
    return {"x": torch.tensor(0)}


def test_supervisor_recovers_from_fault(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=2,
                                                max_retries=3))
    state, report = sup.run(_x0(), _counter_step(fail_at={5}),
                            lambda s: None, start_step=0, num_steps=10)
    assert int(state["x"]) == 10
    assert report.retries == 1
    assert report.restores == 1                # rolled back to step 4 ckpt


def test_supervisor_elastic_shrink_after_repeated_faults(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    calls = []

    def always_fail(state, batch):
        raise TransientFault("dead host")

    good = _counter_step()

    def on_shrink(step):
        calls.append(step)
        return good, (lambda s: None)          # rebuilt step_fn post-shrink

    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=100,
                                                max_retries=2),
                             on_shrink=on_shrink)
    state, report = sup.run(_x0(), always_fail, lambda s: None,
                            start_step=0, num_steps=5)
    assert report.shrinks == 1
    assert calls and int(state["x"]) == 5
    assert report.transient_faults == report.retries
    assert report.permanent_faults == 0


def test_supervisor_permanent_fault_reraises_without_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=100,
                                                max_retries=3))

    def buggy(state, batch):
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        sup.run(_x0(), buggy, lambda s: None, start_step=0, num_steps=5)


def test_supervisor_permanent_fault_single_restore_then_reraise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=2,
                                                max_retries=3))
    fails = []

    def step_fn(state, batch):
        s = int(state["x"])
        if s == 5:
            fails.append(s)
            raise RuntimeError("nan loss")     # not in the allowlist
        return {"x": state["x"] + 1}, {"loss": 0.0}

    with pytest.raises(RuntimeError, match="nan loss"):
        sup.run(_x0(), step_fn, lambda s: None, start_step=0, num_steps=10)
    assert len(fails) == 2


def test_supervisor_classifies_faults_in_report(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=2,
                                                max_retries=3))
    fired = []

    def step_fn(state, batch):
        s = int(state["x"])
        if s == 5 and not fired:
            fired.append(s)
            raise TransientFault("link flap")
        return {"x": state["x"] + 1}, {"loss": 0.0}

    state, report = sup.run(_x0(), step_fn, lambda s: None, start_step=0,
                            num_steps=10)
    assert int(state["x"]) == 10
    assert report.transient_faults == 1
    assert report.permanent_faults == 0
    assert [f["kind"] for f in report.fault_log] == ["transient"]
    assert "link flap" in report.fault_log[0]["error"]


def test_supervisor_detects_straggler(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    clock = FakeClock()
    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=100),
                             clock=clock)
    state, report = sup.run(_x0(), _counter_step(slow_at={8}, clock=clock),
                            lambda s: None, start_step=0, num_steps=12)
    assert report.stragglers == [8]
    assert int(state["x"]) == 12


def test_supervisor_injected_kill_restores_and_replays(tmp_path):
    """A ``FaultSchedule`` kill against "train" fires once at its step, a
    transient fault: the run restores the last checkpoint and replays
    from there."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    seen = []

    def step_fn(state, batch):
        seen.append(batch)
        return {"x": state["x"] + 1}, {"loss": 0.0}

    sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=3),
                             faults=FaultSchedule.parse("kill@4:train"))
    state, report = sup.run(_x0(), step_fn, lambda s: s, start_step=0,
                            num_steps=6)
    assert int(state["x"]) == 6
    assert report.restores == 1 and report.transient_faults == 1
    assert seen == [0, 1, 2, 3, 3, 4, 5]


# --- the training entry point -----------------------------------------------------

ARGV = ["--device", "cpu", "--steps", "12", "--seq-len", "32", "--batch",
        "4", "--ckpt-every", "6", "--log-every", "6"]


def _run(capsys, argv):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = train.main(argv)
    finally:
        torch.set_num_threads(n)
    return rc, capsys.readouterr().out.splitlines()


def test_train_entry_point_loss_falls_and_resumes(tmp_path, capsys):
    """olmo-1b reduced on the CPU: the loss falls (exit 0) with the
    reference's printed lines; a second call finds the step-12
    checkpoint and resumes from it."""
    argv = [*ARGV, "--ckpt-dir", str(tmp_path)]
    rc, out = _run(capsys, argv)
    assert rc == 0, out
    assert out[0].startswith("step     6 loss ") and "ms/step" in out[0]
    assert out[-1].startswith("done: 12 steps, 0 retries, 0 restores; "
                              "final loss ")
    assert CheckpointManager(str(tmp_path)).steps() == [6, 12]
    _, out = _run(capsys, [*argv, "--steps", "6"])
    assert out[0] == "resumed from step 12"
    assert out[1].startswith("step    18 loss ")
    assert out[-1].startswith("done: 6 steps")
    assert CheckpointManager(str(tmp_path)).steps() == [6, 12, 18]


def test_train_entry_point_microbatched(tmp_path, capsys):
    """``--microbatches 2``: the loss still falls, and the checkpoint
    holds the model's leaves and AdamW's under the reference's names,
    restorable into a fresh ``build``."""
    rc, out = _run(capsys, [*ARGV, "--ckpt-dir", str(tmp_path),
                            "--microbatches", "2"])
    assert rc == 0, out
    assert out[-1].startswith("done: 12 steps, 0 retries")
    with open(tmp_path / "step_12" / "meta.json") as f:
        keys = json.load(f)["keys"]
    assert {"0/blocks/wq", "1/.m/blocks/wq", "1/.step"} <= set(keys)
    _, params, opt, _, _ = train.build(
        "olmo-1b", reduced=True, seq_len=32, batch=4, lr=3e-4, steps=12,
        microbatches=2, device="cpu")
    (params, opt), step = CheckpointManager(str(tmp_path)).restore(
        (params, opt))
    assert step == 12 and int(opt.step) == 12


def test_train_entry_point_resumes_across_packages(tmp_path, capsys):
    """A reference checkpoint of olmo-1b reduced (its params and
    ``OptState``) in ``--ckpt-dir``: the port's ``main`` resumes from it
    and trains on; the reference's manager then restores the port's
    newest checkpoint into its own tree."""
    jp, jst = _cross_state()
    jckpt.CheckpointManager(str(tmp_path)).save(4, (jp, jst))
    rc, out = _run(capsys, [*ARGV, "--ckpt-dir", str(tmp_path), "--steps",
                            "8"])
    assert out[0] == "resumed from step 4", out
    assert out[-1].startswith("done: 8 steps, 0 retries"), out
    like = (jax.tree.map(jnp.zeros_like, jp), jadamw_init(jp))
    (rp, rst), step = jckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert step == 12 and int(rst.step) == 10
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(rp))


def test_train_entry_point_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.main(["--mesh", "pod", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
