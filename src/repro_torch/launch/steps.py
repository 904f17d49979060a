"""The train step of the port.

Port of ``repro.launch.steps.make_train_step``, which differentiates
the model's ``loss_fn`` with ``torch.autograd`` in place of
``jax.value_and_grad``: the f32 master params are cast once a step
(``convert.compute_view``) and the gradients land in the f32 leaves;
with ``microbatches`` > 1 the batch rows are cut into that many slices
whose gradients are summed in f32 and averaged, as the reference's scan
does. AdamW updates the params and its state in place (the reference
donates them). The reference's ``make_prefill_step`` /
``make_serve_step`` are the models' ``prefill`` / ``decode_step`` under
``torch.no_grad``, and its ``abstract_cell`` / ``lower_cell`` (sharded
lowering for the dry run) wait for the mesh slice.
"""

from __future__ import annotations

import torch

from ..convert import compute_view
from ..models import get_model
from ..optim import OptState, adamw_update, cosine_schedule
from ..optim.adamw import leaves


def make_train_step(cfg, *, lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, remat: bool = True,
                    microbatches: int = 1):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``:
    params a tree of f32 master tensors, batch a dict of tensors on their
    device with a leading batch axis divisible by ``microbatches``;
    metrics {"loss", "grad_norm", "lr"} (0-d tensors on the device and a
    float)."""
    api = get_model(cfg)
    lr_fn = cosine_schedule(lr, warmup, total)

    def grads_of(params, flat, batch):
        loss = api.loss_fn(cfg, compute_view(params), batch, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt: OptState, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(params, flat, batch)
        else:
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            if any(len(v) != microbatches or v[0].shape[0] * microbatches
                   != batch[k].shape[0] for k, v in parts.items()):
                raise ValueError(f"batch rows must divide into "
                                 f"{microbatches} microbatches")
            loss, grads = 0.0, None
            for i in range(microbatches):
                li, gi = grads_of(params, flat,
                                  {k: v[i] for k, v in parts.items()})
                loss = loss + li
                if grads is None:
                    grads = [g.float() for g in gi]
                else:
                    torch._foreach_add_(grads, gi)
            torch._foreach_div_(grads, float(microbatches))
            loss = loss / microbatches
        params, opt, metrics = adamw_update(params, grads, opt, lr_fn=lr_fn)
        metrics["loss"] = loss
        return params, opt, metrics

    return train_step
