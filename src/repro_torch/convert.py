"""Convert reference parameters into the port's tensors.

``params_from_jax`` takes the reference's nested dict of arrays (numpy,
or anything ``np.asarray`` reads; block params stacked on a leading
layer axis, ``repro.models.transformer.init_params``) and returns the
same names as torch tensors on ``device``: norm scales in f32, every
other leaf cast once to bf16 — the reference casts them to bf16 at each
use, so the numbers are the same.
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
