"""End-to-end training entry point of the port.

Port of ``repro.launch.train``: config -> model -> train step -> data
pipeline -> AdamW -> checkpoint manager -> fault-tolerant supervisor, on
a mesh (``--mesh``, the reference's choices); the token stream is
synthetic (``data.TokenStream``), the weights random f32 masters from
seed 0. Without ``--full`` the reduced config trains; ``--full`` trains
the published config (olmo-1b, the default, needs about 19 GB of f32
params, grads and AdamW state on one card). On the card the flash
attention of the forward runs its kernel and differentiates through the
hand-written backward kernels, and a MoE model's (``--arch olmoe-1b-7b``
or ``deepseek-v2-lite-16b``) expert products run the grouped GEMM kernel
and differentiate through its dX / dW kernels; its loss adds 0.01 x the
load-balance loss, as the reference's does. The full MoE configs need
more training state than one 80 GB card holds (olmoe-1b-7b's 16 layers
about 111 GB); ``build_config`` builds a run from any config, such as
one cut in depth.

``--mesh host`` (the default) trains on a 1x1 ``DeviceMesh`` (nccl on
the card, gloo with ``--device cpu``), where every collective is the
identity and the step is the one device's; ``pod`` and ``multipod`` are
the reference's (16, 16) and (2, 16, 16) meshes, which need a world of
256 or 512 ranks (``torchrun``) and raise in any other. Under a mesh of
more than one rank every family but MoE trains sharded: each rank draws only
its slices of the params (``sharding.param_pspecs``, no FSDP groups, as
the reference's ``build``), takes its rows of each global batch
(``TokenStream.host_batch`` of its shard of the batch dim), and the step runs tensor parallelism,
data parallelism and the sharded norm (``steps.make_train_step``);
checkpoints hold the whole tensors, written by rank 0
(``CheckpointManager``). The MoE family raises there. Rank 0 prints.
Resumes from the newest checkpoint in ``--ckpt-dir`` when it holds one.
Returns 0 when the last loss is below the first.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --seq-len 32 --batch 4 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --device cpu --steps 20 --seq-len 32 --batch 4 --ckpt-dir build/ckpt_moe
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20 \\
      --seq-len 512 --batch 8 --ckpt-dir build/ckpt_full
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..convert import master_params
from ..data import TokenStream
from ..models import get_model
from ..models import layers as L
from ..optim import adamw_init
from ..runtime import ElasticConfig, TrainingSupervisor
from . import sharding as sh
from .mesh import installed, make_host_mesh, make_production_mesh
from .steps import make_train_step


def build(arch: str, *, reduced: bool, seq_len: int, batch: int, lr: float,
          steps: int, microbatches: int, seed: int = 0, device="cuda",
          mesh=None):
    """(cfg, f32 master params, AdamW state, token stream, step function
    taking (params, opt, batch of host tensors)) on ``device`` for
    ``arch``, its reduced config where ``reduced``: ``build_config``."""
    cfg = get_config(arch)
    return build_config(cfg.reduced() if reduced else cfg, seq_len=seq_len,
                        batch=batch, lr=lr, steps=steps,
                        microbatches=microbatches, seed=seed, device=device,
                        mesh=mesh)


def param_specs(cfg, mesh):
    """The params' specs on ``mesh`` (the reference's ``build``: no
    streamed groups), or None at one rank."""
    if mesh is None or mesh.size == 1:
        return None
    api = get_model(cfg)
    return sh.param_pspecs(api.init_params(cfg, device="meta"), mesh)


def build_config(cfg, *, seq_len: int, batch: int, lr: float, steps: int,
                 microbatches: int, seed: int = 0, device="cuda", mesh=None):
    """``build`` from a config: the masters are the model's random init
    from ``seed``, drawn in its serving dtypes and widened to f32. Under
    an installed ``mesh`` of more than one rank, this rank's slices of
    them and of AdamW's state, and a step over the rank's rows."""
    dev = resolve_device(device)
    api = get_model(cfg)
    specs = param_specs(cfg, mesh)
    if specs is None:
        params = api.init_params(cfg, seed=seed, device=dev)
    else:
        L.single_rank_family(cfg)
        params = api.init_params(cfg, seed=seed, device=dev,
                                 local=sh.local_init(specs, mesh))
    params = master_params(params)
    opt = adamw_init(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=batch, seed=seed)
    train_step = make_train_step(cfg, lr=lr, warmup=max(steps // 20, 5),
                                 total=steps, microbatches=microbatches,
                                 specs=specs)

    def step_fn(params, opt, host_batch):
        # pinned, the upload is asynchronous: the host does not wait for
        # the card to drain before enqueuing the step
        pin = dev.type == "cuda"
        return train_step(params, opt, {
            k: (v.pin_memory() if pin else v).to(dev, non_blocking=True)
            for k, v in host_batch.items()})

    return cfg, params, opt, stream, step_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--full", action="store_true",
                    help="the published config on one device instead of "
                         "the reduced one")
    ap.add_argument("--mesh", default="host",
                    choices=("host", "pod", "multipod"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    return ap.parse_args(argv)


def make_training_mesh(args):
    """``--mesh``: the 1x1 host mesh, or the reference's (16, 16) pod or
    (2, 16, 16) multipod, which raise in a world of another size than
    256 or 512."""
    if args.mesh == "host":
        return make_host_mesh(args.device)
    return make_production_mesh(multi_pod=args.mesh == "multipod",
                                device=args.device)


def main(argv=None):
    """Train ``--steps`` steps on ``--mesh``. Returns 0 when the last
    loss is below the first."""
    args = parse_args(argv)
    mesh = make_training_mesh(args)
    try:
        with installed(mesh):
            losses = train(args, mesh)
    finally:
        mesh.close()
    return 0 if losses[-1] < losses[0] else 1


def train(args, mesh) -> list[float]:
    """Train ``args`` on ``mesh`` (installed): every rank of it runs
    this, rank 0 prints. Returns this run's losses, one a step."""
    say = print if not any(mesh.coords.values()) else (lambda *a, **k: None)
    cfg, params, opt, stream, jitted = build(
        args.arch, reduced=not args.full, seq_len=args.seq_len,
        batch=args.batch, lr=args.lr, steps=args.steps,
        microbatches=args.microbatches, device=args.device, mesh=mesh)
    specs = param_specs(cfg, mesh)
    mgr = CheckpointManager(
        args.ckpt_dir, keep=3, mesh=mesh,
        specs=None if specs is None else (specs, sh.opt_pspecs(specs, mesh)))
    sup = TrainingSupervisor(
        mgr, ElasticConfig(checkpoint_every=args.ckpt_every), mesh=mesh)
    shards, shard = sh.shard_index(sh.batch_dim_spec(args.batch, mesh),
                                   mesh)
    batch_fn = stream.batch if shards == 1 else \
        (lambda step: stream.host_batch(step, shard, shards))

    start = 0
    if mgr.latest_step() is not None:
        (params, opt), start = mgr.restore((params, opt))
        say(f"resumed from step {start}")

    losses = []
    t0 = time.monotonic()

    def step_fn(state, batch):
        p, o = state
        p, o, metrics = jitted(p, o, batch)
        losses.append(float(metrics["loss"]))
        n = len(losses)
        if n % args.log_every == 0:
            dt = (time.monotonic() - t0) / n
            say(f"step {start + n:5d} loss "
                f"{np.mean(losses[-args.log_every:]):.4f} "
                f"({dt * 1e3:.0f} ms/step)", flush=True)
        return (p, o), metrics

    (params, opt), report = sup.run(
        (params, opt), step_fn, batch_fn, start_step=start,
        num_steps=args.steps)

    say(f"done: {report.steps_done} steps, "
        f"{report.retries} retries, {report.restores} restores; "
        f"final loss {losses[-1]:.4f} "
        f"(first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    raise SystemExit(main())
