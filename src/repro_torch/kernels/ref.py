"""Plain PyTorch versions of the port's kernels.

Same layouts and semantics as ``repro.kernels.ref``: the CPU path of
every kernel wrapper, and the version ``chip_smoke.py`` holds each
kernel against on the card. Softmax and accumulation run in f32; the
result is cast back to the query's dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, S, H, dh); k/v: (B, T, KV, dh); grouped-query; f32 softmax.

    window > 0 limits attention to the last ``window`` positions. Query
    position i is aligned to key position i + (T - S) (suffix queries).
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, KV, G, dh).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None] + (T - S)
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def decode_attention(q, k, v, lengths, *, scale=None):
    """q: (B, H, dh); k/v: (B, T, KV, dh); lengths: (B,) valid cache length.

    The query attends to cache positions < lengths[b]; a row with length
    0 has no valid keys and yields zeros (the kernels' flush guard).
    """
    B, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, KV, G, dh).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    lengths = lengths.to(q.device)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    out = torch.where(lengths[:, None, None, None] > 0, out, 0.0)
    return out.reshape(B, H, dh).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None):
    """q: (B, H, dh); k/v_pages: (P, page, KV, dh); page_table: (B, M).

    Gathers each sequence's pages into a contiguous (B, M*page, KV, dh)
    cache and applies decode_attention — the semantics the paged kernel
    matches while touching only the owned pages.
    """
    B = q.shape[0]
    M = page_table.shape[1]
    P, page, KV, dh = k_pages.shape
    pt = page_table.long()
    k = k_pages[pt].reshape(B, M * page, KV, dh)
    v = v_pages[pt].reshape(B, M * page, KV, dh)
    return decode_attention(q, k, v, lengths, scale=scale)
