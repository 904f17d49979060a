"""Causal / windowed GQA flash attention on Hopper: the wrapper of
``csrc/flash_attention.cu``, forward and backward.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel ``_kernel``), with its layout. Unlike the reference's
``ops.attention`` this path pads neither S nor T: the kernel masks the
ragged last tiles by the true lengths. The plain versions are
``ref.mha_attention`` and ``ref.flash_attention_bwd``; ``ops`` picks
between them by the tensors' device and makes the pair one autograd
function. These wrappers only launch: they take CUDA tensors and raise on
anything the kernels do not take.

The reference has no backward kernel (its training differentiates jnp
attention through XLA); the port's backward is three launches of its
own: ``flash_bwd_rowdot`` (D = rowsum(dO o O)), ``flash_bwd_dkdv`` (a
key tile of a KV head at a time, summing over the G query heads of its
group inside the program) and ``flash_bwd_dq`` (128 query rows of a head
at a time), with no atomics, so a step repeats bit for bit. dK/dV and dQ
are Hopper kernels: tiles land by TMA through tensor maps built per call
over the tensors' own strides, and every product runs on ``wgmma``. They
take the forward's causal mask or none, not its window.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
_ROWDOT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_void_p]
_DKDV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DQ_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _rows_ok(t) -> bool:
    # 16-byte row loads: contiguous rows at 8-element granularity
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def as_rows(t):
    """``t`` as the kernels take it: itself when its rows are contiguous
    and 16-byte aligned, else a contiguous copy (an upstream gradient may
    arrive in any layout)."""
    return t if _rows_ok(t) else t.contiguous()


def _check_rows(name, t, dtype=torch.bfloat16):
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{name}: need a CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device}")
    if not _rows_ok(t):
        raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                         f"aligned, strides {t.stride()}")


def _check(q, k, v):
    """(B, H, S, T, KV, dh) of a valid call; raises on anything else."""
    B, H, S, dh = q.shape
    KV, T = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)
    if k.shape != (B, KV, T, dh) or v.shape != k.shape or H % KV:
        raise ValueError("flash_attention: inconsistent shapes")
    if dh not in (64, 128):
        raise ValueError(f"no kernel instance for dh={dh}")
    return B, H, S, T, KV, dh


def _strides(*ts):
    """The (batch, head, position) element strides of ``ts`` in one C
    array; the caller keeps it alive across the launch."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    return_lse=False):
    """q: (B, H, S, dh); k/v: (B, KV, T, dh) -> (B, H, S, dh) in q's
    strides. Any strides over the first three axes; the last axis must
    be contiguous. Query row i sits at key position i + T - S; KV head
    is h // (H // KV). bf16 in and out, f32 softmax. ``return_lse`` also
    returns each row's natural-log sum of exp(scale q.k) over its visible
    keys, (B, H, S) f32 (+inf where none), which the backward reads.
    Under autograd call it through ``ops.flash_attention``, whose
    backward is the kernels below: here an input that requires grad
    raises."""
    _build.refuse_grad("flash_attention", q, k, v)
    B, H, S, T, KV, dh = _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = _strides(q, k, v, out)
    fn = _build.function("flash_attention", "flash_attention_bf16", _ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), None if lse is None else lse.data_ptr(),
                    B, H, S, T, H // KV, dh, ctypes.addressof(strides),
                    scale, int(causal), int(window), _stream(q)),
                 "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_bwd_rowdot(out, dout):
    """D = rowsum(dout o out) in f32: (B, H, S, dh) twice -> (B, H, S).
    Each row is read as dh / 8 lanes of 16 bytes."""
    B, H, S, dh = out.shape
    _check_rows("out", out)
    _check_rows("dout", dout)
    if dout.shape != out.shape:
        raise ValueError("flash_bwd_rowdot: inconsistent shapes")
    if dh not in (64, 128):
        raise ValueError(f"no kernel instance for dh={dh}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=out.device)
    strides = _strides(out, dout)
    fn = _build.function("flash_attention", "flash_attention_bwd_rowdot",
                         _ROWDOT_ARGS)
    _build.check(fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                    B, H, S, dh, ctypes.addressof(strides),
                    _stream(out)), "flash_bwd_rowdot")
    flash_bwd_rowdot.launches += 1
    return delta


def _stats(lse, delta, B, H, S):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError(f"{name}: need a contiguous CUDA float32 "
                             f"({B}, {H}, {S}) tensor")


def flash_bwd_dkdv(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """dK, dV (each in k's strides) of the attention ``flash_attention``
    computed, from dout (q's shape), the forward's ``lse`` and
    ``flash_bwd_rowdot``'s ``delta``. A key tile of one KV head sums over
    every query row of its G heads: at dh 128, 64 keys, whose two
    warpgroups own 64 columns each of dK and dV (one block an SM walking
    the tiles); at dh 64, 128 keys, 64 a warpgroup."""
    B, H, S, T, KV, dh = _check(q, k, v)
    _check_rows("dout", dout)
    if dout.shape != q.shape:
        raise ValueError("flash_bwd_dkdv: dout must have q's shape")
    _stats(lse, delta, B, H, S)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = _strides(q, k, v, dout, dk, dv)
    fn = _build.function("flash_attention", "flash_attention_bwd_dkdv",
                         _DKDV_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, KV, S, T, H // KV, dh,
                    ctypes.addressof(strides), scale, int(causal),
                    _stream(q)),
                 "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal=True, scale=None):
    """dQ (in q's strides), from the same inputs as ``flash_bwd_dkdv``.
    A tile of 128 query rows of one head (64 a warpgroup) walks the
    forward's key range, 64 keys a step; one block an SM walks the
    tiles."""
    B, H, S, T, KV, dh = _check(q, k, v)
    _check_rows("dout", dout)
    if dout.shape != q.shape:
        raise ValueError("flash_bwd_dq: dout must have q's shape")
    _stats(lse, delta, B, H, S)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dq = torch.empty_like(q)
    strides = _strides(q, k, v, dout, dq)
    fn = _build.function("flash_attention", "flash_attention_bwd_dq",
                         _DQ_ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), B, H, S, T, H // KV, dh,
                    ctypes.addressof(strides), scale, int(causal),
                    _stream(q)),
                 "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True,
                        scale=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``out`` with its
    ``lse``: the three backward launches in order."""
    delta = flash_bwd_rowdot(out, dout)
    kw = dict(causal=causal, scale=scale)
    dk, dv = flash_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
    return flash_bwd_dq(q, k, v, dout, lse, delta, **kw), dk, dv


flash_attention.launches = 0
flash_bwd_rowdot.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
