"""Convert reference parameters into the port's tensors.

``params_from_jax`` takes the reference's nested dict of arrays (numpy,
or anything ``np.asarray`` reads; block params stacked on a leading
layer axis: ``repro.models.transformer.init_params``,
``repro.models.moe.init_params`` with its nested ``moe`` dict, MLA or
GQA, ``repro.models.whisper.init_params``, or
``repro.models.griffin.init_params`` with its ``super.{rec1,rec2,attn}``
and ``tail`` subtrees) and returns the same names as torch tensors on
``device``: norm scales (``kv_ln``, whisper's layernorm biases and
griffin's RG-LRU ``lam`` too, ``transformer.F32_PARAMS``) in f32, every
other leaf cast once to bf16 — the reference casts them to bf16 at each
use, so the numbers are the same.

``canvas_from_jax`` takes the reference's packed canvas (``w_blocks`` in
meta order, ``meta``, and for the dequant kernels the quantized payload
and scales) and returns the port's tensors with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.layers import COMPUTE_DTYPE, PARAM_DTYPE
from .models.transformer import F32_PARAMS


def params_from_jax(np_params, device="cuda"):
    dev = resolve_device(device)

    def conv(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = conv(leaf)
                continue
            t = torch.tensor(np.asarray(leaf, np.float32), device=dev)
            out[name] = t.to(PARAM_DTYPE if name in F32_PARAMS
                             else COMPUTE_DTYPE)
        return out

    return conv(np_params)


def _tensor(a, device) -> torch.Tensor:
    """numpy (or anything ``np.asarray`` reads) -> tensor, bit for bit;
    bfloat16 arrays (ml_dtypes) travel as their 16-bit patterns."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def canvas_from_jax(w_blocks, meta, payload=None, scales=None,
                    device="cuda") -> dict:
    """The reference's packed arrays -> the port's: ``w_blocks``
    (G, 128, 128) in its dtype, ``payload``/``scales`` (int8 or uint8,
    f32) when given, as tensors on ``device``; ``meta`` (4, G) stays an
    int32 numpy array on the host, where the kernels derive their run
    offsets from it once."""
    dev = resolve_device(device)
    out = {"w_blocks": None if w_blocks is None else _tensor(w_blocks, dev),
           "meta": np.ascontiguousarray(np.asarray(meta), np.int32)}
    if payload is not None:
        out["payload"] = _tensor(payload, dev)
        out["scales"] = _tensor(scales, dev).float()
    return out
