"""The port's kernel ops, dispatched on the tensors' device.

A CUDA tensor launches the Hopper kernel (or the kernel wrapper raises);
a CPU tensor takes the plain PyTorch version in ``ref``. Under autograd
the plain versions differentiate as any torch code, flash attention
through its backward kernels and the grouped expert GEMM through its
dX / dW kernels; every other kernel raises when an input requires grad
(it has no backward yet). ``impl="ref"``
asks for the plain version on any device — the tests and
``chip_smoke.py``'s kernel-vs-plain comparisons use it.

A ``meta`` tensor (a shapes-only trace) takes the attention kernels' and
the grouped GEMM's shapes-only ops in ``meta``, whose FLOP formulas
``FlopCounterMode`` reads; under autograd, their backward kernels'
shapes-only ops too (``_MetaFlash``, ``_MetaGrouped``).
"""

from __future__ import annotations

import torch

from . import decode_attention as _dec
from . import dequant as _dq
from . import flash_attention as _fa
from . import grouped_mvm as _gm
from . import meta as _meta
from . import packed_canvas as _pc
from . import ref


def _plain(impl: str, x) -> bool:
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return impl == "ref" or x.device.type == "cpu"


class _FlashAttention(torch.autograd.Function):
    """The flash forward kernel (which also writes each row's log-sum-exp)
    and its hand-written backward: the row-dot pre-pass, the dK/dV kernel
    and the dQ kernel. Model layouts (B, S, heads, dh) outside, strided
    (B, head, position, dh) views inside."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fa.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, scale=scale)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out,
            _fa.as_rows(dout).transpose(1, 2), lse, **ctx.kw)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


class _MetaFlash(torch.autograd.Function):
    """``_FlashAttention`` on ``meta``: the forward's shapes-only op (and
    an empty log-sum-exp), the three backward ops'."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _meta.flash_attention(q, k, causal, window)
        lse = q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        delta = _meta.flash_bwd_rowdot(out, dout)
        dk, dv = _meta.flash_bwd_dkdv(q, k, v, dout, lse, delta, *ctx.kw)
        return (_meta.flash_bwd_dq(q, k, v, dout, lse, delta, *ctx.kw), dk,
                dv, None, None)


class _MetaGrouped(torch.autograd.Function):
    """``_GroupedMVM`` on ``meta``: the shapes-only forward, dX and dW."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _meta.grouped_mvm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return (_meta.grouped_mvm_bwd_dx(dy, w),
                _meta.grouped_mvm_bwd_dw(x, dy))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    impl: str = "kernel"):
    """GQA attention: q (B, S, H, dh), k/v (B, T, KV, dh) -> (B, S, H, dh).
    Query row i sits at key position i + T - S. Differentiable on either
    path: the plain version through autograd, the kernel through its
    backward kernels (``_FlashAttention``) when grad mode is on and an
    input requires grad; the backward kernels take no window."""
    if q.device.type == "meta":
        if _needs_grad(q, k, v):
            _refuse_window(window)
            return _MetaFlash.apply(q, k, v, causal, window)
        return _meta.flash_attention(q, k, causal, window)
    if _plain(impl, q):
        return ref.mha_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if _needs_grad(q, k, v):
        _refuse_window(window)
        return _FlashAttention.apply(q, k, v, causal, scale)
    # the kernel takes strided (B, head, position, dh) views: no copies
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=scale)
    return out.transpose(1, 2)


def _refuse_window(window: int) -> None:
    if window:
        raise ValueError(f"flash_attention: the backward kernels take no "
                         f"window (window={window}); call it under "
                         f"torch.no_grad()")


def decode_attention(q, k, v, lengths, *, scale=None, impl: str = "kernel"):
    """Decode attention over a dense cache in model layout: q (B, H, dh),
    k/v (B, T, KV, dh), lengths (B,) int32 live keys -> (B, H, dh). Keys
    at or past lengths[b] (or T) are masked; a length-0 row yields zeros.
    The kernel takes the cache as strided (B, KV, T, dh) views: no copy."""
    B, H, dh = q.shape
    KV = k.shape[2]
    if q.device.type == "meta":
        return _meta.decode_attention(q, k)
    if _plain(impl, q):
        return ref.decode_attention(q, k, v, lengths, scale=scale)
    out = _dec.decode_attention(
        q.contiguous().view(B, KV, H // KV, dh), k.transpose(1, 2),
        v.transpose(1, 2), lengths, scale=scale)
    return out.view(B, H, dh)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None, impl: str = "kernel"):
    """Paged decode attention: q (B, H, dh) model layout; k/v_pages
    (KV, P, page, dh) kernel layout (the pools are stored head-major so
    the decode loop pays no relayout); page_table (B, M) int32; lengths
    (B,) int32 -> (B, H, dh)."""
    B, H, dh = q.shape
    KV = k_pages.shape[0]
    if q.device.type == "meta":
        return _meta.paged_decode_attention(q, k_pages, page_table)
    if _plain(impl, q):
        return ref.paged_decode_attention(
            q, k_pages.permute(1, 2, 0, 3), v_pages.permute(1, 2, 0, 3),
            page_table, lengths, scale=scale)
    out = _dec.paged_decode_attention(
        q.contiguous().view(B, KV, H // KV, dh), k_pages, v_pages,
        page_table, lengths, scale=scale)
    return out.view(B, H, dh)


# --- grouped MoE GEMM --------------------------------------------------------------

class _GroupedMVM(torch.autograd.Function):
    """The grouped expert GEMM kernel and its hand-written backward: the
    dX kernel (dY w^T) and the dW kernel (x^T dY), both over the live
    ``rows`` only, as the forward masks them."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return _gm.grouped_mvm(x, w, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _gm.grouped_mvm_bwd_dx(dy, w, rows) \
            if ctx.needs_input_grad[0] else None
        dw = _gm.grouped_mvm_bwd_dw(x, dy, rows) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_mvm(x, w, rows=None, *, impl: str = "kernel"):
    """x (E, C, D) @ w (E, D, F) -> (E, C, F), f32 accumulation, one
    rounding to x's dtype. ``rows`` ((E,) int32, or None for all C):
    expert e's rows past rows[e] come out zero and are never read.
    Differentiable on either path: the plain version through autograd,
    the kernel through its dX / dW kernels (``_GroupedMVM``, bf16) when
    grad mode is on and x or w requires grad."""
    if x.device.type == "meta":
        if _needs_grad(x, w):
            return _MetaGrouped.apply(x, w)
        return _meta.grouped_mvm(x, w)
    if _plain(impl, x):
        return ref.grouped_mvm(x, w, rows)
    if _needs_grad(x, w):
        return _GroupedMVM.apply(x, w, rows)
    return _gm.grouped_mvm(x, w, rows)


def moe_expert_ffn(xe, w_gate, w_up, w_down, rows=None, *,
                   impl: str = "kernel"):
    """SwiGLU over dispatched expert inputs xe (E, C, D): silu(xe @ Wg) *
    (xe @ Wu), then @ Wd, each product rounded to xe's dtype; ``rows``
    as ``grouped_mvm``'s, passed to all three products. Differentiable
    as ``grouped_mvm`` is."""
    h = torch.nn.functional.silu(grouped_mvm(xe, w_gate, rows, impl=impl)) \
        * grouped_mvm(xe, w_up, rows, impl=impl)
    return grouped_mvm(h, w_down, rows, impl=impl)


# --- packed canvas -------------------------------------------------------------------

def packed_canvas_matmul(x_packed, w_blocks, meta, *, impl: str = "kernel",
                         bb=128, bias=None, residual=None, activation=None):
    """Block-compacted multi-layer MVM; meta from build_block_meta.

    Both the kernel and its plain version touch just the stored blocks.
    The optional epilogue ``y = act(y + bias) + residual`` runs on the
    f32 accumulator before the one rounding, as the kernel does it.
    """
    if (activation or "none") not in _pc.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _plain(impl, x_packed):
        runs = _pc.canvas_runs(meta, x_packed.device)
        return ref.packed_canvas_blocks(
            x_packed, w_blocks, runs.meta, runs.c_blocks, bias=bias,
            residual=residual, activation=activation)
    return _pc.packed_canvas_matmul(x_packed, w_blocks, meta, bb=bb,
                                    bias=bias, residual=residual,
                                    activation=activation)


def packed_canvas_matmul_dq(x_packed, wq_blocks, scales, meta, *,
                            precision: str, impl: str = "kernel", bb=128,
                            bias=None, residual=None, activation=None):
    """Packed-canvas MVM over quantized blocks: int8/int4 payload plus
    per-channel scales from ``ref.quantize_blocks``; each block's f32
    partial sum over its integers times its columns' scales, in the
    kernel and in the plain version alike (``ref.packed_canvas_dq``).
    """
    if (activation or "none") not in _pc.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if _plain(impl, x_packed):
        runs = _pc.canvas_runs(meta, x_packed.device)
        return ref.packed_canvas_dq(x_packed, wq_blocks, scales, runs.meta,
                                    runs.c_blocks, precision, bias=bias,
                                    residual=residual, activation=activation)
    return _dq.packed_canvas_matmul_dq(
        x_packed, wq_blocks, scales, meta, precision=precision, bb=bb,
        bias=bias, residual=residual, activation=activation)


build_block_meta = _pc.build_block_meta


def launch_counters() -> tuple:
    """Every kernel wrapper of the port; each counts its launches in
    ``.launches`` (one a call)."""
    return (_dec.paged_decode_attention, _dec.decode_attention,
            _fa.flash_attention, _gm.grouped_mvm, _pc._packed_canvas_matmul,
            _pc._packed_canvas_epilogue, _dq._matmul_dq,
            _dq._matmul_dq_epilogue, _fa.flash_bwd_rowdot,
            _fa.flash_bwd_dkdv, _fa.flash_bwd_dq, _gm.grouped_mvm_bwd_dx,
            _gm.grouped_mvm_bwd_dw)
