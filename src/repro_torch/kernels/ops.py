"""Attention ops in the model layout, dispatched on the tensors' device.

A CUDA tensor launches the Hopper kernel (or the kernel wrapper raises);
a CPU tensor takes the plain PyTorch version in ``ref``. ``impl="ref"``
asks for the plain version on any device — the tests and
``chip_smoke.py``'s kernel-vs-plain comparisons use it.
"""

from __future__ import annotations

from . import decode_attention as _dec
from . import flash_attention as _fa
from . import ref


def _plain(impl: str, x) -> bool:
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return impl == "ref" or x.device.type == "cpu"


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    impl: str = "kernel"):
    """GQA attention: q (B, S, H, dh), k/v (B, T, KV, dh) -> (B, S, H, dh).
    Query row i sits at key position i + T - S."""
    if _plain(impl, q):
        return ref.mha_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    # the kernel takes strided (B, head, position, dh) views: no copies
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=scale)
    return out.transpose(1, 2)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None, impl: str = "kernel"):
    """Paged decode attention: q (B, H, dh) model layout; k/v_pages
    (KV, P, page, dh) kernel layout (the pools are stored head-major so
    the decode loop pays no relayout); page_table (B, M) int32; lengths
    (B,) int32 -> (B, H, dh)."""
    B, H, dh = q.shape
    KV = k_pages.shape[0]
    if _plain(impl, q):
        return ref.paged_decode_attention(
            q, k_pages.permute(1, 2, 0, 3), v_pages.permute(1, 2, 0, 3),
            page_table, lengths, scale=scale)
    out = _dec.paged_decode_attention(
        q.contiguous().view(B, KV, H // KV, dh), k_pages, v_pages,
        page_table, lengths, scale=scale)
    return out.view(B, H, dh)
