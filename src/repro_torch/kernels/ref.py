"""Plain PyTorch versions of the port's kernels.

Same layouts and semantics as ``repro.kernels.ref``: the CPU path of
every kernel wrapper, and the version ``chip_smoke.py`` holds each
kernel against on the card. Softmax and accumulation run in f32; the
result is cast back to the query's dtype.
"""

from __future__ import annotations

import math

import torch

from .packed_canvas import ACTIVATIONS, BLK, META_CB, META_KB

NEG_INF = -1e30
#: symmetric integer range per precision
QMAX = {"int8": 127, "int4": 7}


# --- packed canvas (multi-layer block-packed MVM) -------------------------------

def _epilogue(y, dtype, bias, residual, activation):
    """The kernels' flush on an f32 accumulator: + bias, activation,
    + residual, then one rounding to ``dtype``."""
    if bias is not None:
        y = y + bias.float()
    y = ACTIVATIONS[activation or "none"](y)
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


def packed_canvas(x_packed, w_virtual, *, bias=None, residual=None,
                  activation=None):
    """y = act(x_packed (B, R) @ W_virtual (R, C) + bias) + residual over
    the dense virtual plane (zeros outside the tiles): the oracle. f32
    product, then the epilogue in the kernel's order and one rounding to
    x's dtype; without bias, residual and activation the plain product.
    """
    return _epilogue(x_packed.float() @ w_virtual.float(), x_packed.dtype,
                     bias, residual, activation)


def packed_canvas_blocks(x_packed, w_blocks, meta, c_blocks: int, *,
                         scales=None, chunk_off=None, bias=None,
                         residual=None, activation=None):
    """The packed-canvas kernels' plain version, in their arithmetic
    order: the same function as ``packed_canvas`` over
    ``blocks_to_dense``, computed over the stored blocks only (memory in
    proportion to the blocks, not the plane). Each block's (B, 128)
    product in f32, times its per-column ``scales`` (G, 128) where given
    (the quantized formats: once a block, after the block's sum), summed
    in block order into its chunk (``chunk_off``, a ``split_plan``'s
    block offsets; default one chunk a run), the chunks summed in order
    into their output block, then the epilogue and one rounding."""
    dev = x_packed.device
    meta = torch.as_tensor(meta).to(dev, torch.long)
    B, R = x_packed.shape
    xb = x_packed.float().reshape(B, R // BLK, BLK)[:, meta[META_KB]]
    prod = torch.einsum("bgk,gkn->bgn", xb, w_blocks.float())
    if scales is not None:
        prod = prod * scales.float()
    cb = meta[META_CB]
    if chunk_off is not None:
        off = torch.as_tensor(chunk_off).to(dev, torch.long)
        sizes = off[1:] - off[:-1]
        chunk_of = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev), sizes)
        prod = torch.zeros((B, len(sizes), BLK), dtype=torch.float32,
                           device=dev).index_add_(1, chunk_of, prod)
        cb = cb[off[:-1]]
    y = torch.zeros((B, c_blocks, BLK), dtype=torch.float32, device=dev)
    y.index_add_(1, cb, prod)
    return _epilogue(y.view(B, c_blocks * BLK), x_packed.dtype, bias,
                     residual, activation)


def blocks_to_dense(w_blocks, meta, R: int, C: int):
    """Reconstruct W_virtual (R, C) in f32 from compacted blocks + meta
    (4, G) (numpy or a tensor), on w_blocks' device: the inverse of the
    planner's build_w_blocks."""
    dev = w_blocks.device
    meta = torch.as_tensor(meta).to(dev, torch.long)
    w = torch.zeros((R // BLK, C // BLK, BLK, BLK), dtype=torch.float32,
                    device=dev)
    w[meta[META_KB], meta[META_CB]] = w_blocks.float()
    return w.permute(0, 2, 1, 3).reshape(R, C)


# --- int8 / int4 block quantization (the dequant kernels' encoding) -------------

def quantize_blocks(w_blocks, precision: str):
    """(G, 128, 128) fp blocks -> (payload, scales (G, 128) f32), bit for
    bit the reference's encoding: per-(block, column) scale amax / qmax
    (never below 1e-12), round half to even, clip, and for int4 the +8
    bias with row pairs (2r, 2r+1) in the (low, high) nibbles of one
    byte. payload: int8 (G, 128, 128) or uint8 (G, 64, 128).
    """
    if precision not in QMAX:
        raise ValueError(f"unknown precision {precision!r}")
    if w_blocks.ndim != 3 or w_blocks.shape[1:] != (BLK, BLK):
        raise ValueError(f"need (G, {BLK}, {BLK}) blocks, got "
                         f"{tuple(w_blocks.shape)}")
    w = w_blocks.float()
    qmax = QMAX[precision]
    scales = torch.clamp_min(w.abs().amax(dim=-2) / qmax, 1e-12)
    q = torch.round(w / scales[:, None, :])
    q = torch.clamp(q, -qmax - 1 if precision == "int4" else -qmax, qmax)
    if precision == "int8":
        return q.to(torch.int8), scales
    biased = (q + 8).to(torch.uint8)               # [-8, 7] -> [0, 15]
    lo, hi = biased[:, 0::2, :], biased[:, 1::2, :]
    return lo | (hi << 4), scales


def unpack_blocks(payload, precision: str):
    """The integers q of ``quantize_blocks``' payload -> f32 (G, 128,
    128), exact: int8 as stored, int4 unbiased with its row pairs
    unpacked."""
    if precision not in QMAX:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "int8":
        return payload.float()
    lo = (payload & 0xF).float() - 8.0
    hi = ((payload >> 4) & 0xF).float() - 8.0
    G = payload.shape[0]
    return torch.stack([lo, hi], dim=2).reshape(G, BLK, BLK)


def dequantize_blocks(payload, scales, precision: str):
    """Inverse of ``quantize_blocks`` -> f32 (G, 128, 128)."""
    return unpack_blocks(payload, precision) * scales.float()[:, None, :]


def packed_canvas_dq(x_packed, wq_blocks, scales, meta, c_blocks: int,
                     precision: str, *, chunk_off=None, bias=None,
                     residual=None, activation=None):
    """The dequant kernels' plain version, in their order:
    ``packed_canvas_blocks`` over the blocks' integers in f32, each
    block's f32 partial sum times its columns' scales once, acc[:, c] +=
    s[g, c] * sum_k x[:, k] q[k, c] (the reference multiplies x by q * s
    weight by weight), then the chunks (``chunk_off``) and runs in
    order."""
    return packed_canvas_blocks(
        x_packed, unpack_blocks(wq_blocks, precision), meta, c_blocks,
        scales=scales, chunk_off=chunk_off, bias=bias, residual=residual,
        activation=activation)


# --- grouped MVM (MoE expert GEMM) -----------------------------------------------

def grouped_mvm(x, w, rows=None):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F): f32 products and sums, one
    rounding to x's dtype. ``rows`` (E,) int or None: rows c >= rows[e]
    of expert e come out zero, as the kernel writes them."""
    y = torch.bmm(x.float(), w.float())
    if rows is not None:
        c = torch.arange(x.shape[1], device=x.device)
        y = torch.where((c[None, :] < rows.to(x.device)[:, None])[..., None],
                        y, 0.0)
    return y.to(x.dtype)


def _live(t, rows):
    """``t`` (E, C, ...) with the rows c >= rows[e] of expert e zeroed
    (all rows where ``rows`` is None), in f32."""
    t = t.float()
    if rows is None:
        return t
    c = torch.arange(t.shape[1], device=t.device)
    return torch.where((c[None, :] < rows.to(t.device)[:, None])[..., None],
                       t, 0.0)


def grouped_mvm_bwd_dx(dy, w, rows=None):
    """The dX kernel's plain version: dX (E, C, D) = dY (E, C, F) @ W[e]^T
    over the live rows, f32 products and sums, one rounding to dY's
    dtype; rows c >= rows[e] come out zero. With ``grouped_mvm_bwd_dw``,
    the gradient of ``grouped_mvm(x, w, rows)``'s output."""
    return torch.bmm(_live(dy, rows), w.float().transpose(1, 2)).to(dy.dtype)


def grouped_mvm_bwd_dw(x, dy, rows=None):
    """The dW kernel's plain version: dW (E, D, F) = X[e]^T @ dY[e] summed
    over the live rows c < rows[e] only, f32 products and sums, one
    rounding to x's dtype; an expert with no rows gets zeros."""
    return torch.bmm(_live(x, rows).transpose(1, 2),
                     _live(dy, rows)).to(x.dtype)


# --- attention -------------------------------------------------------------------

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


def _masked_scores(q, k, causal, window, scale):
    """f32 scores (B, KV, G, S, T) of q (B, S, H, dh) against k (B, T,
    KV, dh), -inf where the flash kernels mask, and the grouped q."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, KV, H // KV, dh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None] + (T - S)
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return s.masked_fill(~mask, -math.inf), qg, scale


def attention_lse(q, k, *, causal=True, window=0, scale=None):
    """The flash forward's second output: each query row's natural-log
    sum of exp(scale q.k) over its visible keys, (B, H, S) f32, +inf on
    a row with none. Layouts as ``mha_attention``'s."""
    B, S, H, _ = q.shape
    s, _, _ = _masked_scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)                     # (B, KV, G, S)
    lse = torch.where(torch.isneginf(lse), math.inf, lse)
    return lse.reshape(B, H, S)


def _probs(q, k, lse, causal, scale):
    """P = exp(scale q.k - lse) (B, KV, G, S, T) in f32 from the forward's
    ``lse`` (B, H, S); 0 where masked or where the row has no key."""
    B, S, H, _ = q.shape
    KV = k.shape[2]
    s, qg, scale = _masked_scores(q, k, causal, 0, scale)
    lse = lse.float().reshape(B, KV, H // KV, S)[..., None]
    return torch.where(torch.isinf(lse), 0.0, torch.exp(s - lse)), qg, scale


def _ds(p, v, dout, delta):
    """dS = P o (dO V^T - D) (B, KV, G, S, T) and dO grouped (B, S, KV,
    G, dh), in f32."""
    B, KV, G, S, _ = p.shape
    do = dout.reshape(B, S, KV, G, -1).float()
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    return p * (dp - delta.float().reshape(B, KV, G, S)[..., None]), do


def flash_bwd_rowdot(out, dout):
    """The row-dot pre-pass's plain version: D = rowsum(dout o out) in
    f32, (B, S, H, dh) twice -> (B, H, S)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2)


def flash_bwd_dkdv(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """The dK/dV kernel's plain version from the same inputs (model
    layouts; ``lse`` the forward's, ``delta`` the pre-pass's, both (B, H,
    S)): dk = scale dS^T q summed over each KV head's G query heads, dv =
    P^T dO, each in its input's dtype."""
    p, qg, scale = _probs(q, k, lse, causal, scale)
    ds, do = _ds(p, v, dout, delta)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """The dQ kernel's plain version from the same inputs: dq = scale dS
    K, in q's dtype."""
    B, S, H, dh = q.shape
    p, _, scale = _probs(q, k, lse, causal, scale)
    ds, _ = _ds(p, v, dout, delta)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    return dq.reshape(B, S, H, dh).to(q.dtype)


def flash_attention_bwd(q, k, v, dout, *, causal=True, scale=None):
    """The flash backward's plain version: (dq, dk, dv) of
    ``mha_attention(q, k, v)`` for the upstream gradient ``dout`` (q's
    shape), by the explicit formulas in f32 with the forward recomputed
    exactly: O and lse in f32, D = rowsum(dO o O), dS = P o (dO V^T - D),
    dq = scale dS K, dk = scale dS^T q (summed over each KV head's G query
    heads), dv = P^T dO. A query row with no visible key has P = 0 (the
    kernels' zeros), where ``mha_attention`` would average every value.
    Each result in its input's dtype."""
    B, S, H, dh = q.shape
    kw = dict(causal=causal, scale=scale)
    lse = attention_lse(q, k, **kw)
    p, _, _ = _probs(q, k, lse, **kw)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(B, S, H, dh)
    delta = flash_bwd_rowdot(out, dout)
    dk, dv = flash_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
    return flash_bwd_dq(q, k, v, dout, lse, delta, **kw), dk, dv


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


def decode_attention_split(q, k, v, lengths, splits: int, *, scale=None,
                           tile: int = 64):
    """``decode_attention`` computed as the dense kernel's split-T
    arithmetic: T is cut into ``splits`` chunks of a whole number of
    ``tile``-token tiles (the kernel's chunking); each chunk yields its
    own partial (max m, sum l, accumulator acc) over its live keys, a
    chunk with none gives l = 0, and the partials merge by log-sum-exp.
    A row whose chunks are all empty yields zeros. Same layouts as
    ``decode_attention``; the main path never calls it."""
    B, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    tiles = max(1, -(-T // tile))
    chunk = tile * -(-tiles // min(splits, tiles))
    qg = q.reshape(B, KV, G, dh).float() * scale
    lengths = lengths.to(q.device)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, T)
        pos = torch.arange(lo, max(lo, hi), device=q.device)
        valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
        logits = torch.einsum("bkgd,btkd->bkgt", qg, k[:, lo:hi].float())
        logits = logits.masked_fill(~valid, -math.inf)
        m = logits.amax(-1) if hi > lo else torch.full(
            (B, KV, G), -math.inf, device=q.device)
        p = torch.exp(logits - torch.where(m.isinf(), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = m.amax(0)
    w = torch.where(l > 0, torch.exp(m - torch.where(top.isinf(), 0.0, top)),
                    0.0)
    den = (w * l).sum(0)
    num = (w[..., None] * acc).sum(0)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.reshape(B, H, dh).to(q.dtype)


def _gather_pages(k_pages, v_pages, page_table):
    """Each sequence's pages as a contiguous (B, M * page, KV, dh) cache."""
    B, M = page_table.shape
    P, page, KV, dh = k_pages.shape
    pt = page_table.long()
    return (k_pages[pt].reshape(B, M * page, KV, dh),
            v_pages[pt].reshape(B, M * page, KV, dh))


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None):
    """q: (B, H, dh); k/v_pages: (P, page, KV, dh); page_table: (B, M).

    Gathers each sequence's pages into a contiguous (B, M*page, KV, dh)
    cache and applies decode_attention — the semantics the paged kernel
    matches while touching only the owned pages.
    """
    return decode_attention(q, *_gather_pages(k_pages, v_pages, page_table),
                            lengths, scale=scale)


def paged_decode_attention_split(q, k_pages, v_pages, page_table, lengths,
                                 splits: int, *, scale=None, tile: int = 64):
    """``paged_decode_attention`` computed as the paged kernel's split-T
    arithmetic: the pages gathered as there (T = M * page, so lengths
    past it are clamped), then ``decode_attention_split``. Same layouts
    as ``paged_decode_attention``; the main path never calls it."""
    return decode_attention_split(
        q, *_gather_pages(k_pages, v_pages, page_table), lengths, splits,
        scale=scale, tile=tile)
