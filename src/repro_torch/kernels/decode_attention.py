"""Decode attention on Hopper: the wrappers of
``csrc/paged_decode_attention.cu``.

``paged_decode_attention`` is the counterpart of
``repro.kernels.decode_attention.paged_decode_attention`` (the Pallas TPU
kernel ``_paged_kernel``), ``decode_attention`` of its ``decode_attention``
(``_kernel``: a dense cache), each with the reference's signature and
layout. The plain versions are ``ref.paged_decode_attention`` and
``ref.decode_attention``; ``ops`` picks between them by the tensors'
device. ``ref.decode_attention_split`` is the dense kernel's split-T
arithmetic (partials per chunk, merged by log-sum-exp) in plain PyTorch,
and ``split_plan`` its chunking. These wrappers only launch: they take
CUDA tensors and raise on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
#: tokens a ring stage of the dense kernel; query heads a block (one MMA)
SPLIT_TILE, QROWS = 64, 16


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, KV: int, G: int, T: int, sms: int = 132,
               splits: int | None = None) -> tuple[int, int]:
    """(splits, chunk) of the dense kernel: T cut into ``splits`` chunks of
    ``chunk`` tokens, a whole number of 64-token tiles. A grid of (KV *
    ceil(G / 16), B) blocks that covers at least half of the card's
    ``sms`` SMs is not split: there the combine pass costs more than it
    saves (olmoe's 128 blocks on 132 SMs ran faster unsplit). A smaller
    one is split towards two blocks a SM, keeping about three tiles a
    chunk. The lengths live on the card, so T, the longest any can be,
    sizes the chunks: a chunk past a row's length costs one empty block.
    ``splits`` overrides the count (rounded to whole tiles)."""
    tiles = max(1, -(-T // SPLIT_TILE))
    if splits is None:
        blocks = B * KV * -(-G // QROWS)
        splits = 1 if 2 * blocks >= sms else min(-(-2 * sms // blocks),
                                                 max(1, tiles // 3))
    per = -(-tiles // max(1, min(splits, tiles)))
    return -(-tiles // per), per * SPLIT_TILE


def decode_attention(q, k, v, lengths, *, scale=None, splits=None):
    """q: (B, KV, G, dh); k/v: (B, KV, T, dh); lengths: (B,) int32 live
    keys -> (B, KV, G, dh).

    Sequence b attends keys t < min(lengths[b], T); keys past that are
    never read, and a length-0 row yields zeros. k and v may have any
    strides over their first three axes (the static cache layer
    ``(B, T, KV, dh)`` arrives as its ``transpose(1, 2)`` view, with no
    copy); their last axis must be contiguous, with 16-byte-aligned rows.
    Any G >= 1. T is split across blocks by ``split_plan`` (``splits``
    overrides its count); with more than one split an f32 workspace
    holds the partials and a combine kernel merges them, within the
    same call. bf16 in and out, f32 softmax.
    """
    B, KV, G, dh = q.shape
    T = k.shape[2]
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("lengths", lengths, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous CUDA {dt} tensor, "
                             f"got {t.dtype} on {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: need a CUDA bfloat16 tensor, got "
                             f"{t.dtype} on {t.device}")
        # 16-byte row loads: contiguous rows at 8-element granularity
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned, strides {t.stride()}")
    if k.shape != (B, KV, T, dh) or v.shape != k.shape \
            or lengths.shape != (B,) or G < 1:
        raise ValueError("decode_attention: inconsistent shapes")
    if dh not in (64, 128):
        raise ValueError(f"no kernel instance for dh={dh}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    n_split, chunk = split_plan(B, KV, G, T, _sm_count(q.device.index or 0),
                                splits)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty(B * KV * G * n_split * dh, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(B * KV * G * n_split * 2, dtype=torch.float32,
                              device=q.device)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    fn = _build.function("paged_decode_attention", "decode_attention_bf16",
                         _DENSE_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(),
                    part_acc.data_ptr() if part_acc is not None else None,
                    part_ml.data_ptr() if part_ml is not None else None,
                    B, KV, G, dh, T, n_split, chunk,
                    ctypes.addressof(strides), scale,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "decode_attention")
    decode_attention.launches += 1      # one call: split kernel + combine
    return out


decode_attention.launches = 0
