"""End-to-end training entry point of the port.

Port of ``repro.launch.train``: config -> model -> train step -> data
pipeline -> AdamW -> checkpoint manager -> fault-tolerant supervisor, on
one device; the token stream is synthetic (``data.TokenStream``), the
weights random f32 masters from seed 0. Without ``--full`` the reduced
config trains; ``--full`` trains the published config on one card
(olmo-1b, the default, needs about 19 GB of f32 params, grads and AdamW
state). On the card the flash attention of the forward runs its kernel
and differentiates through the hand-written backward kernels, and a MoE
model's (``--arch olmoe-1b-7b`` or ``deepseek-v2-lite-16b``) expert
products run the grouped GEMM kernel and differentiate through its dX /
dW kernels; its loss adds 0.01 x the load-balance loss, as the
reference's does. The full MoE configs need more training state than
one 80 GB card holds (olmoe-1b-7b's 16 layers about 111 GB);
``build_config`` builds a run from any config, such as one cut in depth.
``--mesh pod|multipod`` (the reference's sharded meshes) waits for the
training half of the mesh slice (ROADMAP, Queue 1, item 4). Resumes from the newest checkpoint
in ``--ckpt-dir`` when it holds one. Returns 0 when the last loss is
below the first.

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
from ..optim import adamw_init
from ..runtime import ElasticConfig, TrainingSupervisor
from .steps import make_train_step


def build(arch: str, *, reduced: bool, seq_len: int, batch: int, lr: float,
          steps: int, microbatches: int, seed: int = 0, device="cuda"):
    """(cfg, f32 master params, AdamW state, token stream, step function
    taking (params, opt, batch of host tensors)) on ``device`` for
    ``arch``, its reduced config where ``reduced``: ``build_config``."""
    cfg = get_config(arch)
    return build_config(cfg.reduced() if reduced else cfg, seq_len=seq_len,
                        batch=batch, lr=lr, steps=steps,
                        microbatches=microbatches, seed=seed, device=device)


def build_config(cfg, *, seq_len: int, batch: int, lr: float, steps: int,
                 microbatches: int, seed: int = 0, device="cuda"):
    """``build`` from a config: the masters are the model's random init
    from ``seed``, drawn in its serving dtypes and widened to f32."""
    dev = resolve_device(device)
    params = master_params(get_model(cfg).init_params(cfg, seed=seed,
                                                      device=dev))
    opt = adamw_init(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=batch, seed=seed)
    train_step = make_train_step(cfg, lr=lr, warmup=max(steps // 20, 5),
                                 total=steps, microbatches=microbatches)

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


def main(argv=None):
    """Train ``--steps`` steps. Returns 0 when the last loss is below the
    first."""
    args = parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training waits for the training "
            f"half of the mesh slice (data parallelism, FSDP, "
            f"vocabulary-parallel cross-entropy, a global gradient norm, "
            f"sharded checkpoints; ROADMAP, Queue 1, item 4); the port "
            f"trains on one device")
    cfg, params, opt, stream, jitted = build(
        args.arch, reduced=not args.full, seq_len=args.seq_len,
        batch=args.batch, lr=args.lr, steps=args.steps,
        microbatches=args.microbatches, device=args.device)

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    sup = TrainingSupervisor(
        mgr, ElasticConfig(checkpoint_every=args.ckpt_every))

    start = 0
    if mgr.latest_step() is not None:
        (params, opt), start = mgr.restore((params, opt))
        print(f"resumed from step {start}")

    losses = []
    t0 = time.monotonic()

    def step_fn(state, batch):
        p, o = state
        p, o, metrics = jitted(p, o, batch)
        losses.append(float(metrics["loss"]))
        n = len(losses)
        if n % args.log_every == 0:
            dt = (time.monotonic() - t0) / n
            print(f"step {start + n:5d} loss "
                  f"{np.mean(losses[-args.log_every:]):.4f} "
                  f"({dt * 1e3:.0f} ms/step)", flush=True)
        return (p, o), metrics

    (params, opt), report = sup.run(
        (params, opt), step_fn, stream.batch, start_step=start,
        num_steps=args.steps)

    print(f"done: {report.steps_done} steps, "
          f"{report.retries} retries, {report.restores} restores; "
          f"final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f})")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
