"""The packing path: the paper's case studies and the packed-canvas
kernels, one JSON row per line.

Counterpart of the JAX package's ``examples/pack_and_report.py`` and of
the canvas rows and ``check()`` of ``benchmarks/bench_kernels.py``, at
their widths:

  * Part 1 — every MLPerf-Tiny workload packed / stacked / flattened on
    the D-IMC and A-IMC baselines (``core``);
  * Part 2a — whisper-tiny's layers on the IMC fabric (``lm_workload``);
  * Part 2b — whisper-tiny's 24 projections on the virtual plane
    (``planner.pack_canvas``), and one fused pass over layer 0's block
    through the packed-canvas kernel, f32, B = 64;
  * the canvas rows: whisper-tiny, the rwkv6-7b mixers (d_model 4096) and
    16 LoRA adapters of 48x48 (blocks, naive blocks, MXU-pass ratio,
    density), and the rwkv mixers end to end through the fp kernel, the
    fused epilogue, and the int8 and int4 dequant kernels (f32, B = 32);
  * the grouped expert GEMM's row: eight olmoe-1b-7b experts' (E 8, C
    128, D 2048, F 1024, f32) products in one launch, against the
    per-expert loop in float64.

Every end-to-end row holds each matrix's output from ``gather_outputs``
against its own ``x @ W`` in f32 (with its dequantized W, bias,
activation and residual where the row has them); ``check`` fails the run
past 1e-3. Runs on the card unless given ``--device cpu``, where every
kernel takes its plain version:

  PYTHONPATH=src python -m repro_torch.launch.pack [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core import (a_imc, d_imc, flattened_plan, lm_workload,
                    mlperf_tiny_suite, pack, plan_cost, stacked_plan)
from ..kernels import ops, ref
from ..kernels.packed_canvas import ACTIVATIONS, BLK, build_block_meta
from ..planner import WeightMatrix, pack_canvas

TOL = 1e-3      # bench_kernels.check's bound on max |err| vs x @ W, f32


def _ceil(x, m=BLK):
    return -(-x // m) * m


# --- Part 1 and 2a: the paper's algorithm -------------------------------------

def paper_case_studies() -> list[dict]:
    """Part 1: min D_m, EDP at the packed budget and streamed layers for
    each MLPerf-Tiny workload and mapping, on D-IMC and A-IMC."""
    rows = []
    for make_arch, label in ((d_imc, "d_imc"), (a_imc, "a_imc")):
        for wl in mlperf_tiny_suite():
            budget = pack(wl, make_arch(1, 1), bounded=False).min_D_m
            arch = make_arch(1, budget)
            plans = {
                "packed": pack(wl, arch, bounded=True),
                "stacked": stacked_plan(wl, arch, bounded=True),
                "flattened": flattened_plan(wl, arch, bounded=True),
            }
            edp0 = plan_cost(plans["packed"]).edp_pj_s
            for m, plan in plans.items():
                edp = plan_cost(plan).edp_pj_s
                rows.append({
                    "name": f"pack/paper/{label}/{wl.name}/{m}",
                    "min_D_m": budget if m == "packed" else None,
                    "EDP_pJs": edp, "EDP_vs_packed": edp / edp0,
                    "streamed": len(plan.streamed_layers)})
    return rows


def lm_packing() -> dict:
    """Part 2a: whisper-tiny's layers packed on four D-IMC macros."""
    wl = lm_workload(get_config("whisper-tiny"), seq_len=64)
    budget = pack(wl, d_imc(4, 1), bounded=False).min_D_m
    plan = pack(wl, d_imc(4, budget), bounded=True)
    return {"name": "pack/lm/whisper-tiny", "layers": len(wl.layers),
            "min_D_m": budget, "EDP_pJs": plan_cost(plan).edp_pj_s,
            **plan.utilization_summary()}


# --- matrix lists of the canvas rows --------------------------------------------

def whisper_mats():
    cfg = get_config("whisper-tiny")
    D, F = cfg.d_model, cfg.d_ff
    mats = []
    for l in range(cfg.num_layers):
        g = f"qkv{l}"
        mats += [WeightMatrix(f"l{l}.wq", D, D, share_group=g),
                 WeightMatrix(f"l{l}.wk", D, D, share_group=g),
                 WeightMatrix(f"l{l}.wv", D, D, share_group=g),
                 WeightMatrix(f"l{l}.wo", D, D),
                 WeightMatrix(f"l{l}.up", D, F),
                 WeightMatrix(f"l{l}.dn", F, D)]
    return mats


def rwkv_mixer_mats():
    # rwkv6 per-block lora mixers: 5 x (32, D) + (D, 160) — tiny, unaligned
    D = get_config("rwkv6-7b").d_model
    mats = [WeightMatrix("mix_w1", D, 160)]
    for i in range(5):
        mats.append(WeightMatrix(f"mix_w2_{i}", 32, D, share_group="m2"))
    mats += [WeightMatrix("w_lora_a", D, 64), WeightMatrix("w_lora_b", 64, D)]
    return mats


def lora_adapter_mats():
    # 16 small unaligned adapters (48x48): multiple tiles per block
    return [WeightMatrix(f"lora{i}", 48, 48) for i in range(16)]


def canvas_case(name, mats) -> dict:
    """Structural row: stored blocks against per-matrix padding."""
    layout = pack_canvas(mats)
    naive_blocks = sum((_ceil(m.rows) // BLK) * (_ceil(m.cols) // BLK)
                       for m in mats)
    vol = sum(m.rows * m.cols for m in mats)
    return {
        "name": f"kernels/canvas/{name}",
        "matrices": len(mats),
        "packed_blocks": layout.num_blocks,
        "naive_blocks": naive_blocks,
        "mxu_pass_ratio": round(naive_blocks / layout.num_blocks, 3),
        "density": round(layout.density, 4),
        "stored_MiB_bf16": round(layout.num_blocks * BLK * BLK * 2 / 2**20,
                                 2),
        "ideal_MiB_bf16": round(vol * 2 / 2**20, 2),
    }


def grouped_case(device, seed: int = 0) -> dict:
    """bench_kernels' grouped row at olmoe-1b-7b widths (8 experts for
    the CPU, as there): one grouped launch of the (E, C, D) @ (E, D, F)
    expert products against the looped experts in float64."""
    cfg = get_config("olmoe-1b-7b")
    E, D, F = 8, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((E, 128, D), generator=gen, device=device)
    w = torch.randn((E, D, F), generator=gen, device=device)
    got = ops.grouped_mvm(x, w)
    err = max((got[e].double() - x[e].double() @ w[e].double()).abs()
              .max().item() for e in range(E))
    return {"name": "kernels/grouped_mvm/olmoe_experts", "experts": E,
            "D": D, "F": F, "max_err_vs_oracle": err,
            "launches_folded": E * 3}   # gate/up/down per expert -> 3


# --- end-to-end passes through the kernels --------------------------------------

def random_problem(mats, batch: int, seed: int):
    """Seeded f32 weights (rows, cols) and inputs (batch, rows); members
    of a share group get one input."""
    rng = np.random.default_rng(seed)
    weights, inputs, shared = {}, {}, {}
    for m in mats:
        weights[m.name] = rng.standard_normal((m.rows, m.cols),
                                              dtype=np.float32)
        x = rng.standard_normal((batch, m.rows), dtype=np.float32)
        inputs[m.name] = shared.setdefault(m.share_group, x) \
            if m.share_group else x
    return weights, inputs


def unpack_matrices(layout, w_blocks) -> dict[str, torch.Tensor]:
    """Each matrix (rows, cols) in f32 read back from blocks in meta
    order: the inverse of ``build_w_blocks``."""
    blocks = layout.blocks
    _, order = build_block_meta(blocks)
    index = np.full((layout.R // BLK, layout.C // BLK), -1, np.int64)
    index[blocks[order][:, 0], blocks[order][:, 1]] = np.arange(len(blocks))
    out = {}
    for name, chunks in layout.placements.items():
        rows = max(p.src_row + p.rows for p in chunks)
        cols = max(p.src_col + p.cols for p in chunks)
        w = torch.zeros((rows, cols), dtype=torch.float32,
                        device=w_blocks.device)
        for p in chunks:
            kb0, kb1 = p.x_off // BLK, _ceil(p.x_off + p.rows) // BLK
            cb0, cb1 = p.y_off // BLK, _ceil(p.y_off + p.cols) // BLK
            idx = torch.as_tensor(index[kb0:kb1, cb0:cb1].reshape(-1),
                                  device=w_blocks.device)
            win = w_blocks[idx].float().view(kb1 - kb0, cb1 - cb0, BLK, BLK)
            win = win.permute(0, 2, 1, 3).reshape((kb1 - kb0) * BLK,
                                                  (cb1 - cb0) * BLK)
            r0, c0 = p.x_off - kb0 * BLK, p.y_off - cb0 * BLK
            w[p.src_row:p.src_row + p.rows, p.src_col:p.src_col + p.cols] = \
                win[r0:r0 + p.rows, c0:c0 + p.cols]
        out[name] = w
    return out


def end_to_end(name, mats, batch, device, *, seed, precision=None,
               bias=False, residual=False, activation=None) -> dict:
    """One packed pass over ``mats`` through the kernel (fp, or int8/int4
    with ``precision``), with the optional epilogue; each matrix's
    gathered output against its own f32 ``x @ W`` with the same weights
    (dequantized where quantized), bias, activation and residual. An
    epilogue needs matrices that do not fold (the activation acts on
    each row chunk's partial sum)."""
    layout = pack_canvas(mats)
    weights, inputs = random_problem(mats, batch, seed)
    meta = layout.block_meta()
    wb = layout.build_w_blocks(weights, dtype=torch.float32, device=device)
    xp = layout.build_x_packed(inputs, batch, dtype=torch.float32,
                               device=device)
    gen = torch.Generator().manual_seed(seed)
    b = torch.randn((layout.C,), generator=gen).to(device) if bias else None
    r = (torch.randn((batch, layout.C), generator=gen).to(device)
         if residual else None)
    if precision is None:
        yp = ops.packed_canvas_matmul(xp, wb, meta, bias=b, residual=r,
                                      activation=activation)
        w_eff = unpack_matrices(layout, wb)
    else:
        payload, scales = ref.quantize_blocks(wb, precision)
        yp = ops.packed_canvas_matmul_dq(xp, payload, scales, meta,
                                         precision=precision, bias=b,
                                         residual=r, activation=activation)
        w_eff = unpack_matrices(
            layout, ref.dequantize_blocks(payload, scales, precision))
    got = layout.gather_outputs(yp)
    bias_of = layout.gather_outputs(b[None]) if bias else {}
    res_of = layout.gather_outputs(r) if residual else {}
    act = ACTIVATIONS[activation or "none"]
    err, rel_fp = 0.0, 0.0
    for m in mats:
        x = torch.as_tensor(inputs[m.name]).to(device)
        y = x @ w_eff[m.name]
        if bias:
            y = y + bias_of[m.name]
        y = act(y)
        if residual:
            y = y + res_of[m.name]
        err = max(err, (got[m.name] - y).abs().max().item())
        if precision is not None:    # what the precision costs against fp
            y_fp = x @ torch.as_tensor(weights[m.name]).to(device)
            rel_fp = max(rel_fp, ((x @ w_eff[m.name] - y_fp).abs().max()
                                  / y_fp.abs().max()).item())
    row = {"name": f"kernels/canvas/{name}", "batch": batch,
           "blocks": layout.num_blocks, "precision": precision or "f32",
           "epilogue": {"bias": bias, "residual": residual,
                        "activation": activation or "none"},
           "max_err_vs_per_matrix": err}
    if precision is not None:
        row["quant_rel_err_vs_fp"] = rel_fp
    return row


def tpu_canvas(device) -> dict:
    """Part 2b: whisper-tiny's projections on the virtual plane, and one
    fused pass over layer 0's six matrices (f32, B = 64)."""
    mats = whisper_mats()
    layout = pack_canvas(mats)
    naive = sum(-(-m.rows // BLK) * -(-m.cols // BLK) for m in mats)
    row = end_to_end("whisper_tiny_layer0_pass", mats[:6], 64, device,
                     seed=0)
    return {"name": "pack/canvas/whisper-tiny", "matrices": len(mats),
            "weights": sum(m.rows * m.cols for m in mats),
            "blocks": layout.num_blocks, "naive_blocks": naive,
            "density": layout.density,
            "layer0_pass_max_err": row["max_err_vs_per_matrix"]}


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    rows = paper_case_studies()
    rows.append(lm_packing())
    rows.append(tpu_canvas(dev))
    rows += [
        canvas_case("whisper_tiny_blocks", whisper_mats()),
        canvas_case("rwkv6_mixers", rwkv_mixer_mats()),
        canvas_case("lora_adapters_48x48", lora_adapter_mats()),
        grouped_case(dev),
    ]
    mats = rwkv_mixer_mats()
    rows += [
        end_to_end("rwkv_end_to_end", mats, 32, dev, seed=1),
        end_to_end("rwkv_epilogue_silu", mats, 32, dev, seed=2, bias=True,
                   residual=True, activation="silu"),
        end_to_end("rwkv_int8", mats, 32, dev, seed=3, precision="int8"),
        end_to_end("rwkv_int4_epilogue_gelu", mats, 32, dev, seed=4,
                   precision="int4", bias=True, residual=True,
                   activation="gelu"),
    ]
    return rows


def check(rows: list[dict]) -> None:
    by = {r["name"]: r for r in rows}
    assert by["kernels/canvas/lora_adapters_48x48"]["mxu_pass_ratio"] \
        > 1.5, "canvas packing must cut block passes on sub-block tiles"
    # aligned whisper blocks pack losslessly (density 1.0, no extra cost)
    assert by["kernels/canvas/whisper_tiny_blocks"]["density"] > 0.99
    assert by["pack/canvas/whisper-tiny"]["layer0_pass_max_err"] < TOL
    assert by["kernels/grouped_mvm/olmoe_experts"]["max_err_vs_oracle"] \
        < TOL
    for r in rows:
        if "max_err_vs_per_matrix" in r:
            assert r["max_err_vs_per_matrix"] < TOL, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows = run(args.device)
    for r in rows:
        print(json.dumps(r))
    check(rows)
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
