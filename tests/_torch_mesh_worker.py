"""One rank of a multi-rank test of the port's mesh (``test_torch_mesh``),
on the CPU over ``gloo``.

  python tests/_torch_mesh_worker.py RANK WORLD STORE JOB OUT

Joins the process group through the file store STORE (a 60 s timeout),
builds the (data, model) mesh the job names, runs each arch's tasks (on
its reduced config) with the mesh installed and writes its results by
arch to OUT.RANK (``torch.save``). Tasks:
  ("draw", seed)   this rank's slices of ``transformer.init_params``;
  ("static", params, tokens, teacher, cache_len)
                   the whole params sharded by ``param_pspecs``, the
                   batch's rows by its spec; the prefill's and each
                   decode step's logits gathered over the vocabulary and
                   the data axes, decoding the ``teacher`` tokens;
  ("engine", params, trace, ecfg)
                   the engine's report on the trace with the sharded
                   params;
  ("refuse", argvs)
                   ``launch.serve.serve`` of each argv on the mesh: the
                   message of the NotImplementedError it raises, or None.
"""

from __future__ import annotations

import copy
import sys
from datetime import timedelta

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
    mesh = make_mesh(job["mesh"], ("data", "model"), device="cpu")
    out_all = {"coords": dict(mesh.coords)}
    for arch, tasks in job["archs"].items():
        with installed(mesh), torch.no_grad():
            out_all[arch] = run(get_config(arch).reduced(), tasks, mesh)
    torch.save(out_all, f"{out}.{rank}")
    dist.barrier()
    mesh.close()
    dist.destroy_process_group()


def run(cfg, tasks, mesh) -> dict:
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.runtime import Engine, EngineConfig

    specs = sh.param_pspecs(T.init_params(cfg, device="meta"), mesh)
    results = {}
    for task in tasks:
        kind = task[0]
        if kind == "draw":
            results["draw"] = T.init_params(
                cfg, task[1], device="cpu",
                local=sh.local_init(specs, mesh))
        elif kind == "static":
            _, params, tokens, teacher, cache_len = task
            params = sh.shard_tree(params, specs, mesh)
            rows = sh.P(sh.batch_dim_spec(tokens.shape[0], mesh))
            e = L.serve_kv_expand(cfg, mesh.shape["model"])

            def full(logits):
                return L.dp_all_gather(L.tp_all_gather(logits, -1), 0)
            logits, state = T.prefill(
                cfg, params, {"tokens": sh.local_slice(tokens, rows,
                                                       mesh)},
                cache_len, kv_expand=e)
            steps = [full(logits)]
            for j in range(teacher.shape[1]):
                logits, state = T.decode_step(
                    cfg, params, state,
                    sh.local_slice(teacher[:, j], rows, mesh))
                steps.append(full(logits))
            results["static"] = {"logits": torch.stack(steps),
                                 "cache_heads": state.k.shape[3],
                                 "cache_rows": state.k.shape[1]}
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


if __name__ == "__main__":
    r, w, store, job, out = sys.argv[1:]
    main(int(r), int(w), store, job, out)
