"""Dry run of the port: trace every (arch x shape x mesh) cell on one
rank's shards, without devices.

The reference lowers and compiles each cell for 512 placeholder XLA
devices. The port runs rank-locally, so its counterpart traces a cell's
step (``steps.lower_cell``) on rank 0's ``meta`` shards of the
production mesh (an ``AbstractMesh``: (16, 16) data x model, or (2, 16,
16) with the outer pod axis), with a ``DryMesh`` counting the
collectives instead of running them. That proves the specs, the local
shapes and the executor's collectives coherent at full size on a CPU. Per cell it records (``<out>/<cell>.json``):

  * the per-chip argument and output bytes of the local shards;
  * ``peak_live_bytes``: the peak of the tensors the step allocates and
    still holds (``steps.LiveBytes``, a dispatch mode: the port's own
    measure, not XLA's memory analysis), and that plus the arguments;
  * FLOPs per chip: ``torch.utils.flop_counter.FlopCounterMode`` over the
    step, the kernels' products (attention and the grouped GEMM) through
    the formulas ``kernels.meta`` registers, also apart as
    ``kernel_flops``;
  * ``collective_bytes_per_chip`` by kind, the result bytes of the
    collectives as the ``DryMesh`` counts them (the reference's
    convention).

A train cell (``kind`` "train": forward, backward and AdamW on the
rank's shards of the f32 params, AdamW's m and v and the batch, FSDP
over the data axis for the planner's streamed groups) also splits its
argument bytes into params, m, v and batch; its collectives are the
tensor-parallel ones of the forward (twice under remat: the recomputed
blocks run theirs again) and the backward, the FSDP gathers and
reduce-scatters, and the gradients' and scalars' all-reduces over the
data axes. A cell the slice does not run is written with ``ok: false``
and the reason, as the reference writes a failing cell: the MoE family's
train cells (its serving cells run: expert parallelism, head-parallel
MLA, group-local dispatch), and the cells whose split cuts a head
(qwen2-vl-7b's 28 heads and whisper-tiny's 6 over 16 model ranks). A
decode cell is one token against a cache whose last row it writes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch command-r-35b,codeqwen1.5-7b,olmo-1b \\
      --shape prefill_32k,decode_32k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch olmo-1b,codeqwen1.5-7b,command-r-35b,command-r-plus-104b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch qwen2-vl-7b,rwkv6-7b,recurrentgemma-9b,whisper-tiny \\
      --shape all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch olmoe-1b-7b,deepseek-v2-lite-16b \\
      --shape prefill_32k,decode_32k --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, get_config, shapes_for
from . import sharding as sh
from .mesh import production_abstract_mesh
from .steps import abstract_cell, lower_cell


def _bytes(tree) -> int:
    """The bytes of a tree's tensors on the chip (``meta``: AdamW's step
    count lives on the host)."""
    return sum(t.numel() * t.element_size() for _, t in sh.flatten(tree)
               if isinstance(t, torch.Tensor) and t.is_meta)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The record of one cell of ``arch``'s published config."""
    return trace_cell(get_config(arch), shape_name, multi_pod)[1]


def trace_cell(cfg, shape_name: str, multi_pod: bool, **cell_kw):
    """(the cell, its record) of ``cfg`` (any config, such as one cut in
    depth) on the production mesh; ``cell_kw`` go to
    ``steps.abstract_cell``."""
    mesh = production_abstract_mesh(multi_pod=multi_pod)
    t0 = time.monotonic()
    cell = abstract_cell(cfg, shape_name, mesh, **cell_kw)
    t1 = time.monotonic()
    low = lower_cell(cell, mesh)
    t2 = time.monotonic()
    arg = _bytes(low.args)
    memory = {}
    if cell.kind == "train":
        params, opt, batch = low.args
        memory["argument_parts_bytes"] = {
            "params": _bytes(params), "m": _bytes(opt.m), "v": _bytes(opt.v),
            "batch": _bytes(batch)}
    return cell, {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": cell.kind,
        "abstract_s": round(t1 - t0, 2), "trace_s": round(t2 - t1, 2),
        "memory": {"argument_bytes": arg,
                   "output_bytes": _bytes(low.out),
                   "peak_live_bytes": low.peak_live_bytes,
                   "peak_with_arguments_bytes": arg + low.peak_live_bytes,
                   **memory,
                   "measure": "port LiveBytes dispatch mode (meta trace)"},
        "cost": {"flops": low.flops, "kernel_flops": low.kernel_flops},
        "collective_bytes_per_chip": low.collective_bytes,
        "ok": True,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for arch in archs:
        shapes = shapes_for(arch) if args.shape == "all" \
            else args.shape.split(",")
        for shape_name in shapes:
            for multi in meshes:
                cell_id = (f"{arch}__{shape_name}__"
                           f"{'multi' if multi else 'single'}")
                path = os.path.join(args.out, cell_id + ".json")
                print(f"=== {cell_id}", flush=True)
                try:
                    rec = run_cell(arch, shape_name, multi)
                except Exception as e:  # noqa: BLE001
                    if not isinstance(e, NotImplementedError):
                        traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                    failures.append(cell_id)
                    if args.fail_fast:
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        raise
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"    -> {'OK' if rec['ok'] else 'FAIL'} "
                      + (f"(trace {rec['trace_s']}s, "
                         f"{rec['cost']['flops'] / 1e12:.3f} TFLOP/chip)"
                         if rec["ok"] else rec["error"]), flush=True)

    print(f"\n{len(failures)} failures" + (": " + ", ".join(failures)
                                           if failures else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
