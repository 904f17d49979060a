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
use, so the numbers are the same. That is right for serving; training
keeps the reference's f32 params (``master=True``: every leaf f32) and
casts them at the top of each step with ``compute_view``, so gradients
land in the f32 leaves while the forward sees the serving dtypes.
``opt_state_from_jax`` takes the reference's ``OptState`` (step, m, v)
the same way, and ``tree_to_numpy`` / ``opt_state_to_numpy`` give the
port's training state back as numpy for the reference.

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
from .optim import OptState


def _dtype(name: str):
    """The serving dtype of a leaf: f32 for ``F32_PARAMS``, else bf16."""
    return PARAM_DTYPE if name in F32_PARAMS else COMPUTE_DTYPE


def params_from_jax(np_params, device="cuda", master: bool = False):
    """The reference's param tree as the port's tensors on ``device``, in
    the serving dtypes, or every leaf in f32 with ``master``."""
    dev = resolve_device(device)

    def conv(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = conv(leaf)
                continue
            t = torch.tensor(np.asarray(leaf, np.float32), device=dev)
            out[name] = t if master else t.to(_dtype(name))
        return out

    return conv(np_params)


def master_params(params):
    """f32 master copies of a param tree in the serving dtypes (what
    every model's ``init_params`` keeps): every floating leaf widened,
    exactly."""
    return {k: master_params(v) if isinstance(v, dict)
            else v.to(PARAM_DTYPE) if v.is_floating_point() else v
            for k, v in params.items()}


def compute_view(params, fsdp=frozenset()):
    """The forward's view of f32 master params: ``F32_PARAMS`` leaves as
    they are, every other floating leaf cast to bf16 — the serving
    dtypes, so the forward is the serving code. The casts are
    differentiable: gradients of the view land in the master leaves.

    ``fsdp`` (under an installed mesh): the paths of the leaves FSDP
    splits over the data axis. Each stays this rank's f32 slice, which
    the model gathers whole, in bf16, where it uses it
    (``layers.fsdp_leaf``)."""
    def view(tree, prefix):
        return {k: view(v, f"{prefix}{k}/") if isinstance(v, dict)
                else v if not v.is_floating_point() or prefix + k in fsdp
                else v.to(_dtype(k)) for k, v in tree.items()}
    return view(params, "")


def opt_state_from_jax(opt, device="cuda") -> OptState:
    """The reference's ``OptState`` (a scalar step, f32 moment trees; any
    leaves ``np.asarray`` reads) as the port's: the step a 0-d int32 host
    tensor, m and v f32 trees on ``device``."""
    return OptState(step=torch.tensor(int(np.asarray(opt.step)),
                                      dtype=torch.int32),
                    m=params_from_jax(opt.m, device, master=True),
                    v=params_from_jax(opt.v, device, master=True))


def tree_to_numpy(tree):
    """A tree of tensors as numpy f32 arrays of the same names (f32
    leaves bit for bit, bf16 ones widened exactly)."""
    return {k: tree_to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in tree.items()}


def opt_state_to_numpy(opt: OptState):
    """(step as np.int32, m, v as numpy trees): the fields of the
    reference's ``OptState``."""
    return (np.int32(int(opt.step)), tree_to_numpy(opt.m),
            tree_to_numpy(opt.v))


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
