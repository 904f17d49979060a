"""Grouped expert GEMM on Hopper: the wrapper of ``csrc/grouped_mvm.cu``.

Counterpart of ``repro.kernels.packed_mvm.grouped_mvm`` (the Pallas TPU
kernel ``_kernel``): ``y[e] = x[e] @ w[e]`` for every expert at once,
(E, C, D) @ (E, D, F) -> (E, C, F), f32 accumulation and one rounding to
x's dtype. The MoE layer's three expert products (gate, up, down) are its
launches. ``rows`` ((E,) int32 on the card) limits expert e to its first
rows[e] rows: the rest of y[e] is zeros, their x rows are never read, and
an expert with none reads no weight.

What bounds it: at decode (C = 8 rows an expert) the weight bytes of the
experts with rows, and at prefill (C = 128) the multiply-adds. The TPU
grid stepped over D in order with the accumulator in VMEM; here one CUDA
block per (expert, c-tile, f-tile) walks D itself through a cp.async
ring, and one c-tile covers every row up to C = 32 (8-, 16- or 32-row
tiles over 64 columns: bf16 on the tensor cores with the weights as the
A operand, so the block only streams them) or C = 128 (a 128 x 128 bf16
tile on the tensor cores), so an expert's weights are read once a launch
there. A larger C takes more 128-row c-tiles. f32 runs on FMAs
(64-row tiles past C = 32). Loads and stores are masked by the true C,
D and F where the reference shrank its tiles to divisors.

The plain version is ``ref.grouped_mvm``; ``ops`` picks between them by the
tensors' device. This wrapper only launches: it takes CUDA tensors and
raises on anything the kernel does not take, and on an input that
requires grad (its gradient runs through ``ops.grouped_mvm``).

``grouped_mvm_bwd_dx`` / ``grouped_mvm_bwd_dw`` launch the backward
kernels of the same file (no Pallas site: the reference differentiates
jnp): dX = dY w^T and dW = x^T dY over the live rows, bf16 on ``wgmma``
with both operands brought into shared memory by TMA under ``mbarrier``s,
a persistent grid walking 128 x 256 output tiles expert-major, each
written once by one block (no atomics); dX's blocks go in two-block
clusters where C holds two row tiles, a pair of tiles sharing one operand
by multicast. At training size each is bound about equally by its
multiply-adds and its bytes (dW writes the whole (E, D, F) gradient). Their plain versions are
``ref.grouped_mvm_bwd_dx`` / ``ref.grouped_mvm_bwd_dw``; ``ops`` runs
them from its autograd function ``_GroupedMVM``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def block_rows(C: int, dtype) -> int:
    """Rows of x a CUDA block takes: the smallest tile of 8, 16 or 32 that
    holds C, else 128 (bf16) or 64 (f32)."""
    for bm in (8, 16, 32):
        if C <= bm:
            return bm
    return 128 if dtype == torch.bfloat16 else 64


def grouped_mvm(x, w, rows=None):
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x's dtype; ``rows``
    (E,) int32 or None (all C rows).

    x and w are contiguous CUDA tensors of one dtype, float32 or bfloat16;
    D and F are multiples of 16 bytes' worth of elements (8 in bf16, 4 in
    f32). Any E <= 65535 and any C. rows[e] is clamped to [0, C] on the
    card.
    """
    _build.refuse_grad("grouped_mvm", x, w)
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped_mvm: x and w must share float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous, 16-byte aligned "
                             f"CUDA tensor, got one on {t.device}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_mvm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (E, C, D), (E, D, F)")
    E, C, D = x.shape
    F = w.shape[2]
    _check_rows("grouped_mvm", rows, E, x.device)
    vec = 16 // x.element_size()
    if D % vec or F % vec:
        raise ValueError(f"grouped_mvm: D ({D}) and F ({F}) must be "
                         f"multiples of {vec} for {x.dtype}")
    if E > 65535:
        raise ValueError(f"{E} experts exceed the grid")
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _build.function("grouped_mvm", "grouped_mvm_launch", _ARGS)
    _build.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    None if rows is None else rows.data_ptr(), E, C, D, F,
                    DTYPES[x.dtype], block_rows(C, x.dtype),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "grouped_mvm")
    grouped_mvm.launches += 1
    return y


def _check_rows(what, rows, E, device):
    if rows is not None and (rows.device != device
                             or rows.dtype != torch.int32
                             or rows.shape != (E,)
                             or not rows.is_contiguous()):
        raise ValueError(f"{what}: rows must be a contiguous ({E},) int32 "
                         f"tensor on {device}")


def _bwd_launch(wrapper, a, b, out_shape, rows, dims):
    """Check a backward launch's bf16 operands ``a`` and ``b``, allocate
    its output, launch the C entry named after ``wrapper`` with (E, C, D,
    F) = ``dims`` and count the launch on ``wrapper``."""
    what = wrapper.__name__
    _build.refuse_grad(what, a, b)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the backward kernels take bfloat16, "
                             f"got {t.dtype}; call the plain version "
                             f"(ref.{what}) for float32")
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous, 16-byte aligned "
                             f"CUDA tensor, got one on {t.device}")
    E, C, D, F = dims
    _check_rows(what, rows, E, a.device)
    if D % 8 or F % 8:
        raise ValueError(f"{what}: D ({D}) and F ({F}) must be multiples "
                         f"of 8")
    if E > 65535:
        raise ValueError(f"{E} experts exceed the grid")
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=a.device)
    if out.numel():
        fn = _build.function("grouped_mvm", f"{what}_launch", _BWD_ARGS)
        _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        None if rows is None else rows.data_ptr(), E, C, D,
                        F, torch.cuda.current_stream(a.device).cuda_stream),
                     what)
        wrapper.launches += 1
    return out


def grouped_mvm_bwd_dx(dy, w, rows=None):
    """dX (E, C, D) = dY (E, C, F) @ w[e]^T, f32 sums, one rounding to
    bf16; rows c >= rows[e] come out zero and their dY rows are never
    counted (a 128-row tile that holds a live row loads them, a tile
    wholly past the live rows loads nothing), and an expert with none
    reads no weight. At training size it is bound about equally by its
    multiply-adds and by reading dY and w once and writing dX. dy and w:
    contiguous bf16 CUDA tensors, w (E, D, F); D and F multiples of 8."""
    if dy.dim() != 3 or w.dim() != 3 or w.shape[0] != dy.shape[0] \
            or w.shape[2] != dy.shape[2]:
        raise ValueError(f"grouped_mvm_bwd_dx: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} are not (E, C, F), (E, D, F)")
    E, C, F = dy.shape
    D = w.shape[1]
    return _bwd_launch(grouped_mvm_bwd_dx, dy, w, (E, C, D), rows,
                       (E, C, D, F))


def grouped_mvm_bwd_dw(x, dy, rows=None):
    """dW (E, D, F) = x[e]^T @ dY[e] summed over the live rows c <
    rows[e] only (the last 64-row chunk's dead rows are zeroed on chip
    before they are multiplied), f32 sums, one rounding to bf16; an
    expert with no rows gets zeros and reads nothing. At training size
    it is bound about equally by its multiply-adds and by writing the
    (E, D, F) output. x (E, C, D) and dy (E, C, F): contiguous bf16 CUDA
    tensors; D and F multiples of 8."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"grouped_mvm_bwd_dw: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} are not (E, C, D), (E, C, F)")
    E, C, D = x.shape
    F = dy.shape[2]
    return _bwd_launch(grouped_mvm_bwd_dw, x, dy, (E, D, F), rows,
                       (E, C, D, F))


grouped_mvm.launches = 0
grouped_mvm_bwd_dx.launches = 0
grouped_mvm_bwd_dw.launches = 0
