"""Shapes-only counterparts of the kernels, for tensors on ``meta``.

A trace on ``meta`` tensors (the dry run's, the counterpart of
``jax.eval_shape``) computes nothing. Each op here is a ``torch.library``
op with a Meta kernel alone: it returns an empty result of its kernel's
shape, and makes no (S, T) score matrix, as the kernels never make one.
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

OPS = (flash_attention, decode_attention, paged_decode_attention,
       grouped_mvm)
