"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_decode_attention.cu``.

Counterpart of ``repro.kernels.decode_attention.paged_decode_attention``
(the Pallas TPU kernel ``_paged_kernel``), with its signature and layout.
The plain version is ``ref.paged_decode_attention``; ``ops`` picks
between them by the tensors' device. This wrapper only launches: it
takes CUDA tensors and raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None):
    """q: (B, KV, G, dh); k/v_pages: (KV, P, page, dh); page_table: (B, M)
    int32 page ids; lengths: (B,) int32 live tokens -> (B, KV, G, dh).

    Sequence b's cache position t lives in page ``page_table[b, t //
    page]`` at row ``t % page``. Table slots at or past ``lengths[b]``
    are never read; a length-0 row yields zeros. lengths[b] must not
    exceed M * page. bf16 in and out, f32 softmax.
    """
    B, KV, G, dh = q.shape
    _, P, page, _ = k_pages.shape
    M = page_table.shape[1]
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("page_table", page_table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA {dt} tensor, "
                             f"got {t.dtype} on {t.device}")
    if k_pages.shape != (KV, P, page, dh) or v_pages.shape != k_pages.shape \
            or lengths.shape != (B,) or page_table.shape[0] != B:
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if dh not in (64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"no kernel instance for dh={dh}, G={G}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _build.function("paged_decode_attention",
                         "paged_decode_attention_bf16", _ARGS)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), B, KV, G, dh, P, page, M, scale,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
