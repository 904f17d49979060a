"""Grouped expert GEMM on Hopper: the wrapper of ``csrc/grouped_mvm.cu``.

Counterpart of ``repro.kernels.packed_mvm.grouped_mvm`` (the Pallas TPU
kernel ``_kernel``): ``y[e] = x[e] @ w[e]`` for every expert at once,
(E, C, D) @ (E, D, F) -> (E, C, F), f32 accumulation and one rounding to
x's dtype. The MoE layer's three expert products (gate, up, down) are its
launches.

What bounds it: at decode (C = 8 rows an expert) the weight bytes — every
expert's (D, F) matrix is read once a launch, 369 MB at deepseek-v2-lite
widths — and at prefill (C = 128) the multiply-adds. The TPU grid stepped
over D in order with the accumulator in VMEM; here one CUDA block per
(expert, c-tile, 128-column f-tile) walks D itself through a two-stage
cp.async ring, so the next weight chunk is in flight while the current
one is multiplied, and loads and stores are masked by the true C, D and F
where the reference shrank its tiles to divisors. C <= 32 takes 8-row
tiles and f32 FMAs; a larger C takes 64-row tiles, on the tensor cores
(mma.sync) in bf16 and on FMAs in f32.

The plain version is ``ref.grouped_mvm``; ``ops`` picks between them by the
tensors' device. This wrapper only launches: it takes CUDA tensors and
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of x per CUDA block: the kernel has an 8-row and a 64-row instance
BM_SMALL, BM_LARGE = 8, 64
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def grouped_mvm(x, w):
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x's dtype.

    x and w are contiguous CUDA tensors of one dtype, float32 or bfloat16;
    D and F are multiples of 16 bytes' worth of elements (8 in bf16, 4 in
    f32). Any E <= 65535 and any C.
    """
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
    vec = 16 // x.element_size()
    if D % vec or F % vec:
        raise ValueError(f"grouped_mvm: D ({D}) and F ({F}) must be "
                         f"multiples of {vec} for {x.dtype}")
    if E > 65535:
        raise ValueError(f"{E} experts exceed the grid")
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bm = BM_SMALL if C <= 32 else BM_LARGE
    fn = _build.function("grouped_mvm", "grouped_mvm_launch", _ARGS)
    _build.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, D, F,
                    DTYPES[x.dtype], bm,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "grouped_mvm")
    grouped_mvm.launches += 1
    return y


grouped_mvm.launches = 0
