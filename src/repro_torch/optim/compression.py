"""int8 gradient compression with stochastic rounding.

Port of ``repro.optim.compression``: each tensor is quantized to int8
with a per-tensor f32 scale (max |g| / 127), rounding up with
probability equal to the fractional part, so the quantizer is unbiased.
The reference draws its bits from a ``jax.random`` key split per leaf;
here an explicit ``torch.Generator`` (on the tensors' device) draws
them, leaf by leaf in order: the same distribution, other bits.
"""

from __future__ import annotations

import torch


def int8_compress(tree, generator: torch.Generator):
    """tree of f32/bf16 tensors -> (tree of int8, tree of 0-d f32
    scales); the leaves draw their bits in sorted-key order."""
    if isinstance(tree, dict):
        out = {k: int8_compress(tree[k], generator) for k in sorted(tree)}
        return ({k: q for k, (q, _) in out.items()},
                {k: s for k, (_, s) in out.items()})
    g = tree.float()
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    x = g / scale
    lo = torch.floor(x)
    up = torch.rand(g.shape, generator=generator, device=g.device) < (x - lo)
    return torch.clamp(lo + up, -127, 127).to(torch.int8), scale


def int8_decompress(q_tree, scales, dtype=torch.float32):
    if isinstance(q_tree, dict):
        return {k: int8_decompress(q_tree[k], scales[k], dtype)
                for k in q_tree}
    return (q_tree.float() * scales).to(dtype)
