"""Decode attention on Hopper: the wrappers of
``csrc/paged_decode_attention.cu``.

``paged_decode_attention`` is the counterpart of
``repro.kernels.decode_attention.paged_decode_attention`` (the Pallas TPU
kernel ``_paged_kernel``), ``decode_attention`` of its ``decode_attention``
(``_kernel``: a dense cache), each with the reference's signature and
layout; both run one split-T routine. The plain versions are
``ref.paged_decode_attention`` and ``ref.decode_attention``; ``ops`` picks
between them by the tensors' device. ``ref.decode_attention_split`` and
``ref.paged_decode_attention_split`` are the kernels' split-T arithmetic
(partials per chunk, merged by log-sum-exp) in plain PyTorch, and
``split_plan`` their chunking. These wrappers only launch: they take
CUDA tensors and raise on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
#: tokens a ring stage of the split kernels; query heads a block (one MMA)
SPLIT_TILE, QROWS = 64, 16
#: the paged entry's longest chunk, in tiles. On the H100, over the
#: lengths of all 282 decode steps of chip_smoke (b)'s codeqwen engine run
#: (8 slots, 40-page table rows: T 640), the kernel took a step 0.0342 ms
#: unsplit (the dense plan), 0.0303 / 0.0309 / 0.0277 / 0.0278 / 0.0321
#: in 2 / 3 / 4 / 5 / 10 chunks; 3 tiles gives the 4 chunks
PAGED_CHUNK_TILES = 3


def _workspaces(q, n_split: int):
    """The f32 partials (acc, then max and sum) of a split launch, or
    (None, None) for one split."""
    if n_split == 1:
        return None, None
    rows = q.numel() // q.shape[-1]
    return (torch.empty(rows * n_split * q.shape[-1], dtype=torch.float32,
                        device=q.device),
            torch.empty(rows * n_split * 2, dtype=torch.float32,
                        device=q.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None, splits=None):
    """q: (B, KV, G, dh); k/v_pages: (KV, P, page, dh); page_table: (B, M)
    int32 page ids; lengths: (B,) int32 live tokens -> (B, KV, G, dh).

    Sequence b's cache position t lives in page ``page_table[b, t //
    page]`` at row ``t % page``. Table slots at or past ``lengths[b]``
    are never read; a length-0 row yields zeros; lengths past M * page
    are clamped to it. Any G >= 1, dh in {64, 128}. The dense kernel's
    split-T routine: ``split_plan`` over M * page, the longest a row can
    be (the lengths stay on the card), in chunks of at most
    ``PAGED_CHUNK_TILES`` tiles, ``splits`` overriding its count;
    with more than one split an f32 workspace holds the partials and a
    combine kernel merges them, within the same call. bf16 in and out,
    f32 softmax.
    """
    _build.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
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
            or lengths.shape != (B,) or page_table.shape[0] != B or G < 1:
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if dh not in (64, 128):
        raise ValueError(f"no kernel instance for dh={dh}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    n_split, chunk = split_plan(B, KV, G, M * page,
                                _build.sm_count(q.device.index or 0), splits,
                                max_tiles=PAGED_CHUNK_TILES)
    out = torch.empty_like(q)
    part_acc, part_ml = _workspaces(q, n_split)
    fn = _build.function("paged_decode_attention",
                         "paged_decode_attention_bf16", _ARGS)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), _ptr(part_acc), _ptr(part_ml),
                    B, KV, G, dh, P, page, M, n_split, chunk, scale,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "paged_decode_attention")
    paged_decode_attention.launches += 1   # one call: split kernel + combine
    return out


paged_decode_attention.launches = 0


def split_plan(B: int, KV: int, G: int, T: int, sms: int = 132,
               splits: int | None = None,
               max_tiles: int | None = None) -> tuple[int, int]:
    """(splits, chunk) of the split-T kernels: T cut into ``splits``
    chunks of ``chunk`` tokens, a whole number of 64-token tiles. A grid
    of (KV * ceil(G / 16), B) blocks that covers at least half of the
    card's ``sms`` SMs is not split: there the combine pass costs more
    than it saves (olmoe's 128 blocks on 132 SMs ran faster unsplit). A
    smaller one is split towards two blocks a SM, keeping about three
    tiles a chunk. ``max_tiles`` caps a chunk's tiles whatever the grid:
    the paged entry's rows are ragged, and its longest row, walked by one
    block, sets the time. The lengths live on the card, so T, the longest
    any can be, sizes the chunks: a chunk past a row's length costs one
    empty block. ``splits`` overrides the count (rounded to whole
    tiles)."""
    tiles = max(1, -(-T // SPLIT_TILE))
    if splits is None:
        blocks = B * KV * -(-G // QROWS)
        splits = 1 if 2 * blocks >= sms else min(-(-2 * sms // blocks),
                                                 max(1, tiles // 3))
        if max_tiles:
            splits = max(splits, -(-tiles // max_tiles))
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
    _build.refuse_grad("decode_attention", q, k, v)
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
    n_split, chunk = split_plan(B, KV, G, T,
                                _build.sm_count(q.device.index or 0), splits)
    out = torch.empty_like(q)
    part_acc, part_ml = _workspaces(q, n_split)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    fn = _build.function("paged_decode_attention", "decode_attention_bf16",
                         _DENSE_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), _ptr(part_acc),
                    _ptr(part_ml), B, KV, G, dh, T, n_split, chunk,
                    ctypes.addressof(strides), scale,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "decode_attention")
    decode_attention.launches += 1      # one call: split kernel + combine
    return out


decode_attention.launches = 0
