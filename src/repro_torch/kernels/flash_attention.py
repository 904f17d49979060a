"""Causal / windowed GQA flash attention on Hopper: the wrapper of
``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel ``_kernel``), with its layout. Unlike the reference's
``ops.attention`` this path pads neither S nor T: the kernel masks the
ragged last tiles by the true lengths. The plain version is
``ref.mha_attention``; ``ops`` picks between them by the tensors'
device. This wrapper only launches: it takes CUDA tensors and raises on
anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, H, S, dh); k/v: (B, KV, T, dh) -> (B, H, S, dh) in q's
    strides. Any strides over the first three axes; the last axis must
    be contiguous. Query row i sits at key position i + T - S; KV head
    is h // (H // KV). bf16 in and out, f32 softmax."""
    B, H, S, dh = q.shape
    KV, T = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: need a CUDA bfloat16 tensor, got "
                             f"{t.dtype} on {t.device}")
        # 16-byte row loads: contiguous rows at 8-element granularity
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned, strides {t.stride()}")
    if k.shape != (B, KV, T, dh) or v.shape != k.shape or H % KV:
        raise ValueError("flash_attention: inconsistent shapes")
    if dh not in (64, 128):
        raise ValueError(f"no kernel instance for dh={dh}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    fn = _build.function("flash_attention", "flash_attention_bf16", _ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, H, S, T, H // KV, dh,
                    ctypes.addressof(strides), scale, int(causal),
                    int(window), torch.cuda.current_stream(q.device)
                    .cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
