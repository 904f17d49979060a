"""AdamW + cosine schedule + global-norm clipping over trees of tensors.

Port of ``repro.optim.adamw``: the same formulas in the same order (clip
by the global norm, then per leaf m, v, the bias-corrected step and a
weight decay on every leaf), as ``torch._foreach`` ops. Not
``torch.optim.AdamW``, whose update order differs (it decays the weights
before the Adam step). The reference returns new pytrees; here the
params, m and v are updated in place (the reference donates them), and
the step count lives on the host, where the schedule is computed in f32
as the reference computes it on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class OptState:
    step: torch.Tensor         # 0-d int32 on the host
    m: Any                     # tree like params, f32
    v: Any


def leaves(tree) -> list:
    """A param tree's tensors in the reference's flatten order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params) -> OptState:
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=_zeros_like(params), v=_zeros_like(params))


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """lr(step): linear warmup, then a cosine to 0 at ``total_steps``, in
    f32."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(int(step))
        warm = step / f32(max(warmup_steps, 1))
        prog = (step - f32(warmup_steps)) / f32(max(total_steps
                                                     - warmup_steps, 1))
        prog = np.clip(prog, f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * prog))
        return float(f32(base_lr) * (warm if step < warmup_steps else cos))
    return lr


def clip_by_global_norm(grads: list, max_norm: float, *,
                        replication: list | None = None, mesh=None):
    """Scale the tensors of ``grads`` in place so their global L2 norm is
    at most ``max_norm``; returns (grads, the norm before clipping as a
    0-d f32 tensor on their device).

    Under a ``mesh`` of more than one rank each tensor is this rank's
    slice of a leaf that ``replication[i]`` ranks hold alike
    (``launch.sharding.replication``): the squared norms of the slices,
    each divided by its replication, are summed over every axis of the
    mesh, so each element of the whole tree counts once and every rank
    gets the same norm. At one rank it is the reference's formula."""
    if mesh is None or mesh.size == 1:
        gn = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        sq = torch.stack([torch.square(torch.linalg.vector_norm(g.float()))
                          / r for g, r in zip(grads, replication)]).sum()
        gn = torch.sqrt(mesh.all_reduce(sq, mesh.axis_names))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, gn


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr_fn,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 replication: list | None = None, mesh=None):
    """One AdamW step over ``params`` (a tree) with ``grads`` (the
    tensors of ``leaves(params)``, in that order; clipped in place).
    Updates params, m and v in place; returns (params, the new state,
    metrics {"grad_norm", "lr"}). Under a ``mesh`` the params, grads and
    moments are this rank's slices, and the clip's norm is taken over the
    whole tree (``clip_by_global_norm``'s ``replication``)."""
    flat_p = leaves(params)
    grads = [g.float() for g in grads]
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                       replication=replication, mesh=mesh)
    step = int(state.step) + 1
    lr = lr_fn(step)
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    m, v = leaves(state.m), leaves(state.v)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
    p32 = [p.float() for p in flat_p]
    delta = torch._foreach_div(m, bc1)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    del den
    torch._foreach_add_(delta, p32, alpha=weight_decay)
    torch._foreach_add_(p32, delta, alpha=-lr)
    for p, q in zip(flat_p, p32):
        if q is not p:                 # a non-f32 leaf: round back once
            p.copy_(q)
    return params, OptState(step=torch.tensor(step, dtype=torch.int32),
                            m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}
