"""Shapes-only counterparts of the kernels, for tensors on ``meta``.

A trace on ``meta`` tensors (the dry run's, the counterpart of
``jax.eval_shape``) computes nothing. Each op here is a ``torch.library``
op with a Meta kernel alone: it returns an empty result of its kernel's
shape, and makes no (S, T) score matrix, as the kernels never make one.
The backward kernels have theirs too (the flash backward's row-dot,
dK/dV and dQ, the grouped GEMM's dX and dW), which ``ops``' autograd
functions call on ``meta``, so a training trace reaches neither a kernel
nor a plain version.
Each op's FLOPs (its kernel's products over the key pairs or rows it
takes, every one live) are registered with ``torch.utils.flop_counter``,
so ``FlopCounterMode`` counts them beside every other op's. ``ops``
calls these on ``meta`` tensors; nothing here knows who traces.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

# one namespace for each loaded copy of the package (a parent tree may be
# loaded beside this one under another name)
NAMESPACE = __name__.replace(".", "_")
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _op(schema: str, shape_fn, flops_fn):
    """Define ``schema`` with ``shape_fn`` as its Meta kernel and
    ``flops_fn`` (the argument shapes -> FLOPs) as its FLOP formula."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, shape_fn, "Meta")
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op)(
        lambda *args, out_shape=None, **kwargs: flops_fn(*args))
    return op


def causal_pairs(S: int, T: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention of S queries over T keys
    scores (query i at key position i + T - S), within ``window``."""
    w = window or T

    def upto(n: int) -> int:         # sum of min(h, w) for h = 1 .. n
        m = min(n, w)
        return m * (m + 1) // 2 + (n - m) * w

    return upto(T) - upto(max(T - S, 0))


def _flash_flops(q, k, causal: bool, window: int) -> int:
    B, S, H, dh = q
    T = k[1]
    pairs = causal_pairs(S, T, window) if causal else S * T
    return 4 * B * H * pairs * dh            # two products a pair


flash_attention = _op(
    "flash_attention(Tensor q, Tensor k, bool causal, int window) -> Tensor",
    lambda q, k, causal, window: torch.empty_like(q), _flash_flops)

# q (B, H, dh) over a dense cache k (B, T, KV, dh)
decode_attention = _op(
    "decode_attention(Tensor q, Tensor k) -> Tensor",
    lambda q, k: torch.empty_like(q),
    lambda q, k: 4 * q[0] * q[1] * k[1] * q[2])

# q (B, H, dh) over pages k_pages (KV, P, page, dh) through page_table (B, M)
paged_decode_attention = _op(
    "paged_decode_attention(Tensor q, Tensor k_pages, Tensor page_table) "
    "-> Tensor",
    lambda q, k_pages, page_table: torch.empty_like(q),
    lambda q, kp, table: 4 * q[0] * q[1] * table[1] * kp[2] * q[2])

# x (E, C, D) @ w (E, D, F)
grouped_mvm = _op(
    "grouped_mvm(Tensor x, Tensor w) -> Tensor",
    lambda x, w: x.new_empty((*x.shape[:2], w.shape[-1])),
    lambda x, w: 2 * x[0] * x[1] * x[2] * w[-1])

# the flash backward, model layouts: q, dq (B, S, H, dh), k, v (B, T, KV,
# dh), out and dout as q, lse and the row-dot delta (B, H, S) f32. The
# row-dot is out . dout a row; dK/dV recomputes S = Q K^T and forms dV
# (P^T dO), dP (dO V^T) and dK (dS^T Q): four products a live pair; dQ
# recomputes S and dP and forms dQ (dS K): three.
flash_bwd_rowdot = _op(
    "flash_bwd_rowdot(Tensor out, Tensor dout) -> Tensor",
    lambda out, dout: out.new_empty(
        (out.shape[0], out.shape[2], out.shape[1]), dtype=torch.float32),
    lambda out, dout: 2 * out[0] * out[1] * out[2] * out[3])


def _bwd_flops(products: int):
    def flops(q, k, v, dout, lse, delta, causal, window):
        return products // 2 * _flash_flops(q, k, causal, window)
    return flops


flash_bwd_dkdv = _op(
    "flash_bwd_dkdv(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
    "Tensor delta, bool causal, int window) -> (Tensor, Tensor)",
    lambda q, k, v, dout, lse, delta, causal, window: (
        torch.empty_like(k), torch.empty_like(v)), _bwd_flops(4))

flash_bwd_dq = _op(
    "flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
    "Tensor delta, bool causal, int window) -> Tensor",
    lambda q, k, v, dout, lse, delta, causal, window: torch.empty_like(q),
    _bwd_flops(3))

# the grouped GEMM's backward: dX = dY w^T (E, C, D), dW = x^T dY (E, D, F)
grouped_mvm_bwd_dx = _op(
    "grouped_mvm_bwd_dx(Tensor dy, Tensor w) -> Tensor",
    lambda dy, w: dy.new_empty((*dy.shape[:2], w.shape[1])),
    lambda dy, w: 2 * dy[0] * dy[1] * dy[2] * w[1])

grouped_mvm_bwd_dw = _op(
    "grouped_mvm_bwd_dw(Tensor x, Tensor dy) -> Tensor",
    lambda x, dy: x.new_empty((x.shape[0], x.shape[2], dy.shape[2])),
    lambda x, dy: 2 * x[0] * x[1] * x[2] * dy[2])

OPS = (flash_attention, decode_attention, paged_decode_attention,
       grouped_mvm, flash_bwd_rowdot, flash_bwd_dkdv, flash_bwd_dq,
       grouped_mvm_bwd_dx, grouped_mvm_bwd_dw)
