"""Dequantizing packed canvas on Hopper: quantized blocks in, fp out.

Counterpart of ``repro.kernels.dequant`` (the Pallas TPU kernels
``_kernel_dq`` and ``_kernel_dq_epilogue``). The block loop of
``csrc/packed_canvas.cu`` reads the int8 or int4 payload raw and expands
each weight to bf16 in registers as the tensor-core fragment is formed
(bf16 x; the integers are exact in bf16), or to f32 on the FMA routine
(f32 x). The per-column scale multiplies each block's f32 partial sum
once: acc[:, c] += s[g, c] * sum_k x[:, k] q[k, c]. The fp weight plane
is never written to device memory, so a launch reads the payload's
bytes and no more.

Encoding, per 128x128 block and output channel (column) c — the same
bits as the reference's ``quantize_blocks``:

  * scale[g, c] = max(|W[g, :, c]|) / qmax   (symmetric, per-channel);
  * int8: q = round(W / scale) in [-127, 127], stored as int8
    (G, 128, 128);
  * int4: q in [-8, 7] stored biased by +8 in [0, 15], row pairs
    (2r, 2r+1) packed into one byte (low, high nibble): (G, 64, 128)
    uint8.

``ref.quantize_blocks``/``ref.dequantize_blocks`` are the plain pair;
the model-layout helpers ``quantize_tensor``/``dequantize_tensor``/
``fake_quant`` apply the same per-channel encoding to 2D weights.
"""

from __future__ import annotations

import torch

from . import packed_canvas as _pc
from .ref import QMAX


def packed_canvas_matmul_dq(x_packed, wq_blocks, scales, meta, *,
                            precision: str, bb: int = 128, bias=None,
                            residual=None, activation=None):
    """``packed_canvas_matmul`` over QUANTIZED blocks: each block's
    integers multiply x inside the block loop, its f32 partial sum meets
    the block's per-column scales once, and the optional
    bias/activation/residual epilogue fuses at the flush exactly as in
    the fp kernel.

    wq_blocks/scales from ``ref.quantize_blocks``; meta (4, G) from
    ``build_block_meta``; the fp-kernel contract otherwise applies.
    """
    if precision not in QMAX:
        raise ValueError(f"unknown precision {precision!r}")
    if bias is None and residual is None and activation is None:
        return _matmul_dq(x_packed, wq_blocks, scales, meta,
                          precision=precision, bb=bb)
    return _matmul_dq_epilogue(x_packed, wq_blocks, scales, meta,
                               precision=precision, bb=bb, bias=bias,
                               residual=residual, activation=activation)


def _matmul_dq(x_packed, wq_blocks, scales, meta, *, precision, bb):
    out = _pc.launch(x_packed, wq_blocks, scales, precision, meta, bb=bb)
    _matmul_dq.launches += 1
    return out


def _matmul_dq_epilogue(x_packed, wq_blocks, scales, meta, *, precision,
                        bb, bias, residual, activation):
    out = _pc.launch(x_packed, wq_blocks, scales, precision, meta,
                     bias=bias, residual=residual,
                     activation=activation or "none", bb=bb)
    _matmul_dq_epilogue.launches += 1
    return out


_matmul_dq.launches = 0
_matmul_dq_epilogue.launches = 0


# --- model-layout helpers (output-quality differentials) --------------------


def quantize_tensor(w: torch.Tensor, precision: str,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a model-layout 2D
    weight (in_dim, out_dim) WITHOUT block packing: returns (q f32
    integer grid, scales (out_dim,) f32)."""
    if precision not in QMAX:
        raise ValueError(f"unknown precision {precision!r}")
    wf = torch.as_tensor(w).float()
    amax = wf.abs().amax(dim=0)
    scales = torch.clamp_min(amax / QMAX[precision], 1e-12)
    qmax = QMAX[precision]
    lo = -qmax - 1 if precision == "int4" else -qmax
    q = torch.clamp(torch.round(wf / scales), lo, qmax)
    return q, scales


def dequantize_tensor(q: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (q * scales).to(dtype)


def fake_quant(w: torch.Tensor, precision: str) -> torch.Tensor:
    """Round-trip a model-layout 2D weight through ``precision`` (the
    same values the kernel would compute, fp layout)."""
    if precision in ("fp", "off"):
        return w
    q, s = quantize_tensor(w, precision)
    return dequantize_tensor(q, s, w.dtype)
