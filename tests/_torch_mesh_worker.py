"""One rank of a multi-rank test of the port's mesh (``test_torch_mesh``,
``test_torch_mesh_train``), on the CPU over ``gloo``.

  python tests/_torch_mesh_worker.py RANK WORLD STORE JOB OUT

Joins the process group through the file store STORE (a 60 s timeout),
builds the mesh the job names (its shape over ``axes``, by default
(data, model)), runs each arch's tasks (on its reduced config, through
its family's model) with the mesh installed and writes its results by
arch to OUT.RANK (``torch.save``). Serving tasks run without grad:
  ("draw", seed)   this rank's slices of the model's ``init_params``;
  ("static", params, tokens, teacher, cache_len[, opts])
                   the whole params sharded by ``param_pspecs``, the
                   batch's rows by its spec; the prefill's and each
                   decode step's logits gathered over the vocabulary and
                   the data axes, decoding the ``teacher`` tokens. opts:
                   "extras" (the batch's frames or patch embeddings,
                   whole), "f32" (the port's compute dtypes f32 for the
                   task, the params f32), "name" (the result's key,
                   default "static"), "state" (the decode state after
                   the last step, each leaf gathered whole over the axes
                   ``state_pspecs`` splits it on), "keeps" (the MoE
                   family: the route keep masks of the prompt's
                   ``forward(return_route_keep=True)``, gathered over the
                   data axes) and "routes" (the MoE family: each
                   ``layers.moe_ffn`` call's router probabilities and
                   expert choices, as ``_torch_parity.port_routes``
                   records them, gathered over the data axes);
  ("engine", params, trace, ecfg)
                   the engine's report on the trace with the sharded
                   params;
  ("refuse", argvs)
                   ``launch.serve.serve`` of each argv on the mesh: the
                   message of the NotImplementedError it raises, or None;
  ("sample", argv, opts)
                   ``launch.serve``'s static mode of argv on the mesh:
                   this rank's ``init_params`` draw, then the tokens of
                   ``static_decode`` (opts "f32" as the static task's).
An arch's key may name a config of its own: job["configs"][key] is
(arch, fields of its reduced config to replace).
Training tasks (``run_train``), each with a case dict (its results
stored under its "name"): the reference's
master params (numpy), the batches (numpy, global), "f32" (both
``COMPUTE_DTYPE``s of the port set to f32 for the task, then restored:
this process's own state), "steps", "microbatches", "fsdp" (every
residency group streamed) and "solo" (rank 0 alone, without a mesh:
the one-rank port; the others wait at a barrier):
  ("train", case)  ``make_train_step`` (lr 1e-3, warmup 2, total 10,
                   remat) on this rank's slices and rows: each step's
                   loss and gradient norm, the first moment after step 1
                   and the params after the last step, gathered whole;
                   with "save" (dir, step) a checkpoint of that step,
                   and with "watch" too the whole leaves that save held
                   (``_watched_save``);
  ("ckpt", case)   the same resumed from the newest checkpoint in
                   case["dir"] (restored sliced to this mesh), run to
                   "steps";
  ("fault", case)  the steps through ``TrainingSupervisor`` with a
                   checkpoint every step in case["dir"] and the
                   ``FaultSchedule`` case["faults"]: the params, the
                   report's restores and every step restored;
  ("entry", case)  ``launch.train.train`` of case["argv"] on the mesh,
                   twice (the second resumes from the first's
                   checkpoint): each call's losses and the steps saved
                   in case["dir"];
  ("refuse_train", {"argvs": argvs})
                   ``launch.train.train`` of each argv on the mesh: the
                   message of the NotImplementedError it raises, or None.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys
import weakref
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, store: str, job_path: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import installed, make_mesh

    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(job["mesh"], job.get("axes", ("data", "model")),
                     device="cpu")
    out_all = {"coords": dict(mesh.coords)}
    for key, tasks in job["archs"].items():
        arch, fields = job.get("configs", {}).get(key, (key, {}))
        cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
        serving = [t for t in tasks if t[0] not in TRAIN_TASKS]
        with installed(mesh), torch.no_grad():
            out_all[key] = run(cfg, serving, mesh)
        for task in tasks:
            if task[0] in TRAIN_TASKS:
                out_all[key][task[1]["name"]] = run_train(cfg, task, mesh)
    torch.save(out_all, f"{out}.{rank}")
    dist.barrier()
    mesh.close()
    dist.destroy_process_group()


def run(cfg, tasks, mesh) -> dict:
    from repro_torch.launch import sharding as sh
    from repro_torch.models import get_model
    from repro_torch.runtime import Engine, EngineConfig

    api = get_model(cfg)
    specs = sh.param_pspecs(api.init_params(cfg, device="meta"), mesh)
    results = {}
    for task in tasks:
        kind = task[0]
        if kind == "draw":
            results["draw"] = api.init_params(
                cfg, task[1], device="cpu",
                local=sh.local_init(specs, mesh))
        elif kind == "static":
            opts = task[5] if len(task) > 5 else {}
            with compute_dtype(opts.get("f32")):
                results[opts.get("name", "static")] = _static(
                    cfg, api, specs, mesh, *task[1:5], opts)
        elif kind == "sample":
            from repro_torch.launch import serve
            _, argv, opts = task
            args = serve.parse_args(argv)
            with compute_dtype(opts.get("f32")):
                results["sample"] = serve.static_decode(
                    cfg, serve.init_params(cfg, args, mesh), args, mesh)[0]
        elif kind == "engine":
            _, params, trace, ecfg = task
            results["engine"] = Engine(
                cfg, sh.shard_tree(params, specs, mesh),
                EngineConfig(**ecfg)).run(copy.deepcopy(trace))
        elif kind == "refuse":
            from repro_torch.launch import serve
            results["refuse"] = []
            for argv in task[1]:
                try:
                    serve.serve(serve.parse_args(argv), mesh)
                    results["refuse"].append(None)
                except NotImplementedError as e:
                    results["refuse"].append(str(e))
    return results


def _static(cfg, api, specs, mesh, params, tokens, teacher, cache_len,
            opts) -> dict:
    """The "static" task: prefill and teacher-forced decode steps on the
    rank's slices and rows."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L
    params = sh.shard_tree(params, specs, mesh)
    rows = sh.P(sh.batch_dim_spec(tokens.shape[0], mesh))
    e = L.serve_kv_expand(cfg, mesh.shape["model"])

    def full(logits):
        return L.dp_all_gather(L.whole_vocab(logits, cfg.vocab_size), 0)
    batch = {"tokens": tokens, **opts.get("extras", {})}
    batch = {k: sh.local_slice(torch.as_tensor(v), rows, mesh)
             for k, v in batch.items()}
    out = {}
    if opts.get("keeps"):
        out["keeps"] = L.dp_all_gather(api.forward(
            cfg, params, batch, return_route_keep=True)[1], 1)
    with _routes(opts.get("routes")) as routes:
        logits, state = api.prefill(cfg, params, batch, cache_len,
                                    kv_expand=e)
        steps = [full(logits)]
        for j in range(teacher.shape[1]):
            logits, state = api.decode_step(
                cfg, params, state, sh.local_slice(teacher[:, j], rows,
                                                   mesh))
            steps.append(full(logits))
    out["logits"] = torch.stack(steps)
    if routes is not None:
        out["routes"] = routes
    if hasattr(state, "k"):
        out.update(cache_heads=state.k.shape[3], cache_rows=state.k.shape[1])
    if opts.get("state"):
        token = L.set_shard_ctx(None, None)     # the whole state's shapes
        try:
            whole = api.init_decode_state(cfg, tokens.shape[0], cache_len,
                                          kv_expand=e, device="meta")
        finally:
            L.reset_shard_ctx(token)
        st_specs = sh.state_pspecs(whole, mesh)
        out["state"] = sh.tree_map(lambda path, leaf: sh.gather_leaf(
            leaf, sh.leaf_at(st_specs, path), mesh), state)
    return out


@contextlib.contextmanager
def _routes(record):
    """Where ``record``, each ``layers.moe_ffn`` call's (router
    probabilities (N, E), expert choices (N, k)) over the whole batch
    (gathered over the data axes), as numpy, in call order; else None."""
    import repro_torch.models.layers as TL
    if not record:
        yield None
        return
    seen, moe_ffn = [], TL.moe_ffn

    def recorded(x2d, p, dims, **kw):
        probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
        idx = torch.topk(probs, dims.top_k, dim=-1)[1]
        seen.append((TL.dp_all_gather(probs, 0).numpy(),
                     TL.dp_all_gather(idx, 0).numpy()))
        return moe_ffn(x2d, p, dims, **kw)
    TL.moe_ffn = recorded
    try:
        yield seen
    finally:
        TL.moe_ffn = moe_ffn


TRAIN_TASKS = ("train", "ckpt", "fault", "entry", "refuse_train")


def run_train(cfg, task, mesh):
    """One training task (see the module's docstring)."""
    from repro_torch.launch.mesh import installed
    kind, case = task
    if kind == "refuse_train":
        from repro_torch.launch import train
        out = []
        with installed(mesh):
            for argv in case["argvs"]:
                try:
                    train.train(train.parse_args(argv), mesh)
                    out.append(None)
                except NotImplementedError as e:
                    out.append(str(e))
        return out
    if kind == "entry":
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.launch import train

        with installed(mesh), compute_dtype(case.get("f32")):
            losses = [train.train(train.parse_args(case["argv"]), mesh)
                      for _ in range(2)]
        return {"losses": losses,
                "steps": CheckpointManager(case["dir"]).steps()}
    if case.get("solo"):
        out = None
        if mesh.coords == dict.fromkeys(mesh.coords, 0):
            with compute_dtype(case.get("f32")):
                out = _train(cfg, kind, case, None)
        dist.barrier()
        return out
    with installed(mesh), compute_dtype(case.get("f32")):
        return _train(cfg, kind, case, mesh)


@contextlib.contextmanager
def compute_dtype(f32):
    """The port's compute dtypes (``layers`` and ``convert``) f32 inside,
    where ``f32`` is true; restored after."""
    import repro_torch.convert as CV
    import repro_torch.models.layers as TL
    saved = TL.COMPUTE_DTYPE, CV.COMPUTE_DTYPE
    if f32:
        TL.COMPUTE_DTYPE = CV.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        TL.COMPUTE_DTYPE, CV.COMPUTE_DTYPE = saved


def _train(cfg, kind, case, mesh):
    """``kind``'s steps of ``case`` on ``mesh`` (None: one rank)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import (ElasticConfig, FaultSchedule,
                                     TrainingSupervisor)

    full = params_from_jax(case["params"], device="cpu", master=True)
    specs = groups = None
    if mesh is not None:
        groups = frozenset(sh._GROUP_PATTERNS) if case.get("fsdp") \
            else frozenset()
        specs = sh.param_pspecs(full, mesh, streamed_groups=groups)
        params = sh.shard_tree(full, specs, mesh)
    else:
        params = full
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=1e-3, warmup=2, total=10, remat=True,
                              microbatches=case.get("microbatches", 1),
                              specs=specs)
    tree_specs = None if mesh is None else (specs, sh.opt_pspecs(specs,
                                                                 mesh))

    def rows(step):
        batch = {k: torch.as_tensor(v) for k, v in
                 case["batches"][step].items()}
        if mesh is None:
            return batch
        spec = sh.P(sh.batch_dim_spec(batch["tokens"].shape[0], mesh), None)
        return {k: sh.local_slice(v, spec, mesh) for k, v in batch.items()}

    def whole(tree):
        if mesh is None:
            return sh.tree_map(lambda _, t: t.detach().clone(), tree)
        return sh.tree_map(lambda path, leaf: sh.gather_leaf(
            leaf, sh.leaf_at(specs, path), mesh), tree)

    out = {"loss": [], "grad_norm": [], "restored": []}
    if kind == "fault":
        mgr = CheckpointManager(case["dir"], keep=2, specs=tree_specs,
                                mesh=mesh)
        restore = mgr.restore

        def recorded(*a, **kw):
            tree, step = restore(*a, **kw)
            out["restored"].append(step)
            return tree, step
        mgr.restore = recorded
        sup = TrainingSupervisor(mgr, ElasticConfig(checkpoint_every=1),
                                 faults=FaultSchedule.parse(case["faults"]),
                                 mesh=mesh)

        def one(state, batch):
            p, o, m = step_fn(*state, batch)
            out["loss"].append(float(m["loss"]))
            return (p, o), m
        (params, opt), report = sup.run((params, opt), one, rows,
                                        start_step=0,
                                        num_steps=case["steps"])
        out.update(restores=report.restores, retries=report.retries,
                   params=whole(params))
        return out
    start = 0
    if kind == "ckpt":
        mgr = CheckpointManager(case["dir"], specs=tree_specs, mesh=mesh)
        (params, opt), start = mgr.restore((params, opt))
        out["restored"].append(start)
    for i in range(start, case["steps"]):
        params, opt, m = step_fn(params, opt, rows(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["m1"] = whole(opt.m)
        if case.get("save") and case["save"][1] == i + 1:
            mgr = CheckpointManager(case["save"][0], specs=tree_specs,
                                    mesh=mesh)
            if case.get("watch"):
                out["save_watch"] = _watched_save(mgr, i + 1,
                                                  (params, opt))
            else:
                mgr.save(i + 1, (params, opt))
    out["params"] = whole(params)
    return out


def _watched_save(mgr, step, tree) -> dict:
    """``mgr.save(step, tree)`` with the whole leaves it handles watched:
    the tensors ``sharding.gather_leaf`` returns and the arrays the
    manager writes (``manager._to_numpy``). Returns {"leaves": the
    tensor leaves gathered, "kept": those this rank kept a host copy of,
    "live": the most whole leaves of earlier gathers still alive when a
    gather began}."""
    import repro_torch.checkpoint.manager as M
    from repro_torch.launch import sharding as sh
    seen = {"leaves": 0, "kept": 0, "live": 0}
    refs = []
    gather, to_numpy = sh.gather_leaf, M._to_numpy

    def watched_gather(leaf, spec, mesh, *, keep=True):
        seen["live"] = max(seen["live"],
                           sum(r() is not None for r in refs))
        out = gather(leaf, spec, mesh, keep=keep)
        if isinstance(leaf, torch.Tensor):
            seen["leaves"] += 1
            if out is not None:
                seen["kept"] += 1
                refs.append(weakref.ref(out))
        return out

    def watched_numpy(leaf):
        arr, dt = to_numpy(leaf)
        if isinstance(arr, np.ndarray) and arr.ndim:
            refs.append(weakref.ref(arr))
        return arr, dt
    sh.gather_leaf, M._to_numpy = watched_gather, watched_numpy
    try:
        mgr.save(step, tree)
    finally:
        sh.gather_leaf, M._to_numpy = gather, to_numpy
    return seen


if __name__ == "__main__":
    r, w, store, job, out = sys.argv[1:]
    main(int(r), int(w), store, job, out)
