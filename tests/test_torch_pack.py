"""The port's packing path against the JAX package, on the CPU.

``repro_torch.core`` (the paper's packer and cost model), the virtual-
plane planner and the packing entry point ``repro_torch.launch.pack``
on the same inputs as ``repro.core``, ``repro.planner.mxu_pack``,
``examples/pack_and_report.py`` and ``benchmarks/bench_kernels.py``. The
packer and planner are pure Python and must agree exactly; the
arrays they build agree bit for bit; the Fig. 8 rows agree with
``tests/golden/bench_fig8_mapping.json`` within that file's own test's
tolerance (rel 1e-6).
"""

import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget
from repro.planner import mxu_pack as jmx
from repro_torch import core as tcore
from repro_torch.configs import get_config
from repro_torch.launch import pack as tpack
from repro_torch.planner import mxu_pack as tmx

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))          # benchmarks/ lives at the repo root
from benchmarks import bench_fig8_mapping as f8  # noqa: E402
from benchmarks import bench_kernels as bk  # noqa: E402

GOLDEN_RTOL = 1e-6     # tests/test_golden_regression.py's RTOL
SUITE = [wl.name for wl in tcore.mlperf_tiny_suite()]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny CPU ops: no thread-pool contention
    yield
    torch.set_num_threads(n)


# --- core: the paper's packer and cost model ------------------------------------

def _plans(core, wl_name, arch_name):
    wl = {w.name: w for w in core.mlperf_tiny_suite()}[wl_name]
    make = getattr(core, arch_name)
    out = {}
    for method, fn in (("packed", core.pack), ("stacked", core.stacked_plan),
                       ("flattened", core.flattened_plan)):
        out[method + "_min_D_m"] = fn(wl, make(1, 1), bounded=False).min_D_m
    arch = make(1, out["packed_min_D_m"])
    for method, fn in (("packed", core.pack), ("stacked", core.stacked_plan),
                       ("flattened", core.flattened_plan)):
        plan = fn(wl, arch, bounded=True)
        rep = core.plan_cost(plan)
        out[method] = (rep.edp_pj_s, rep.e_weight_pj, rep.latency_ns,
                       sorted(plan.streamed_layers),
                       sum(t.folds for t in plan.tiles.values()))
    return out


@pytest.mark.parametrize("arch_name", ["d_imc", "a_imc"])
@pytest.mark.parametrize("wl_name", SUITE)
def test_mlperf_tiny_plans_match_reference(arch_name, wl_name):
    """min D_m of every mapping, and EDP, weight energy, latency,
    streamed layers and folds at the packed budget: identical."""
    assert _plans(tcore, wl_name, arch_name) == \
        _plans(jcore, wl_name, arch_name)


@pytest.mark.parametrize("arch", ["whisper-tiny", "codeqwen1.5-7b",
                                  "rwkv6-7b"])
@pytest.mark.parametrize("fine", [False, True])
def test_lm_workload_matches_reference(arch, fine):
    got = tcore.lm_workload(get_config(arch), seq_len=64, fine=fine,
                            unique_layers=arch == "whisper-tiny")
    want = jcore.lm_workload(jget(arch), seq_len=64, fine=fine,
                             unique_layers=arch == "whisper-tiny")
    assert got.name == want.name
    assert [dataclasses.asdict(l) for l in got.layers] == \
        [dataclasses.asdict(l) for l in want.layers]


def test_fig8_rows_on_the_port_core_match_golden(monkeypatch):
    """bench_fig8_mapping.run() recomputed with the port's core in place
    of the reference's, against the pinned golden rows."""
    for name in ("d_imc", "flattened_plan", "mlperf_tiny_suite", "pack",
                 "plan_cost", "stacked_plan"):
        monkeypatch.setattr(f8, name, getattr(tcore, name))
    got = {r["name"]: r for r in f8.run()}
    want = {r["name"]: r
            for r in json.loads((REPO / "tests" / "golden" /
                                 "bench_fig8_mapping.json").read_text())}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert sorted(got[name]) == sorted(w), name
        for k, wv in w.items():
            if isinstance(wv, float):
                assert got[name][k] == pytest.approx(wv, rel=GOLDEN_RTOL,
                                                     abs=1e-12), (name, k)
            else:
                assert got[name][k] == wv, (name, k)
    f8.check(list(got.values()))


# --- planner: the virtual-plane layout and its arrays ---------------------------

def _reduced_codeqwen(WM):
    cfg = get_config("codeqwen1.5-7b").reduced()
    D, F = cfg.d_model, cfg.d_ff
    return [WM("q", D, cfg.q_dim, share_group="qkv"),
            WM("k", D, cfg.kv_dim, share_group="qkv"),
            WM("v", D, cfg.kv_dim, share_group="qkv"),
            WM("o", cfg.q_dim, D),
            WM("gate", D, F, share_group="gu"),
            WM("up", D, F, share_group="gu"),
            WM("down", F, D)]


def _mats(case, WM):
    """(mats, pack_canvas kwargs) of each planner case, built from the
    given WeightMatrix class."""
    if case == "whisper":
        return [WM(m.name, m.rows, m.cols, m.share_group)
                for m in tpack.whisper_mats()], {}
    if case == "rwkv_mixers":
        return [WM(m.name, m.rows, m.cols, m.share_group)
                for m in tpack.rwkv_mixer_mats()], {}
    if case == "lora":
        return [WM(m.name, m.rows, m.cols, m.share_group)
                for m in tpack.lora_adapter_mats()], {}
    # small tiles force column chunks and row folds
    return _reduced_codeqwen(WM), dict(max_tile_rows=48, max_tile_cols=40)


CASES = ["whisper", "rwkv_mixers", "lora", "codeqwen_reduced_folded"]


@pytest.mark.parametrize("case", CASES)
def test_pack_canvas_matches_reference(case):
    tm, kw = _mats(case, tmx.WeightMatrix)
    jm, _ = _mats(case, jmx.WeightMatrix)
    got, want = tmx.pack_canvas(tm, **kw), jmx.pack_canvas(jm, **kw)
    assert (got.R, got.C) == (want.R, want.C)
    assert {n: [dataclasses.astuple(p) for p in ps]
            for n, ps in got.placements.items()} == \
        {n: [dataclasses.astuple(p) for p in ps]
         for n, ps in want.placements.items()}
    np.testing.assert_array_equal(got.blocks, want.blocks)
    np.testing.assert_array_equal(got.block_meta(), want.block_meta())
    assert got.density == want.density
    if case == "codeqwen_reduced_folded":
        down = got.placements["down"]
        assert len({p.src_row for p in down}) > 1      # folded rows
        assert len({p.src_col for p in got.placements["gate"]}) > 1


@pytest.mark.parametrize("case", CASES)
def test_built_arrays_match_reference(case):
    tm, kw = _mats(case, tmx.WeightMatrix)
    jm, _ = _mats(case, jmx.WeightMatrix)
    got, want = tmx.pack_canvas(tm, **kw), jmx.pack_canvas(jm, **kw)
    weights, inputs = tpack.random_problem(tm, 5, seed=0)
    np.testing.assert_array_equal(
        got.build_w_blocks(weights, dtype=torch.float32, device="cpu").numpy(),
        np.asarray(want.build_w_blocks(weights, dtype=jnp.float32)))
    np.testing.assert_array_equal(
        got.build_w_virtual(weights, device="cpu").numpy(),
        np.asarray(want.build_w_virtual(weights)))
    xt = got.build_x_packed(inputs, 5, dtype=torch.float32, device="cpu")
    xj = want.build_x_packed({n: jnp.asarray(v) for n, v in inputs.items()},
                             5, dtype=jnp.float32)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    y = np.random.default_rng(1).standard_normal((5, got.C), np.float32)
    gt, gj = got.gather_outputs(torch.tensor(y)), \
        want.gather_outputs(jnp.asarray(y))
    assert sorted(gt) == sorted(gj)
    for n in gt:
        np.testing.assert_allclose(gt[n].numpy(), np.asarray(gj[n]),
                                   rtol=1e-6, atol=1e-6)
    # bf16 blocks carry the same values, so the reference's blocks convert
    wj = want.build_w_blocks(weights, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        got.build_w_blocks(weights, dtype=torch.bfloat16,
                           device="cpu").float().numpy(),
        np.asarray(wj, np.float32))


def test_canvas_from_jax_carries_the_reference_arrays_bit_for_bit():
    from repro.kernels import dequant as jdq
    from repro_torch.convert import canvas_from_jax
    jm, _ = _mats("lora", jmx.WeightMatrix)
    layout = jmx.pack_canvas(jm)
    weights, _ = tpack.random_problem(jm, 1, seed=2)
    wb = layout.build_w_blocks(weights, dtype=jnp.bfloat16)
    q, s = jdq.quantize_blocks(wb, "int4")
    got = canvas_from_jax(np.asarray(wb), layout.block_meta(),
                          payload=np.asarray(q), scales=np.asarray(s),
                          device="cpu")
    assert got["w_blocks"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w_blocks"].float().numpy(),
                                  np.asarray(wb, np.float32))
    np.testing.assert_array_equal(got["meta"], layout.block_meta())
    np.testing.assert_array_equal(got["payload"].numpy(), np.asarray(q))
    np.testing.assert_array_equal(got["scales"].numpy(), np.asarray(s))


# --- the slice as a whole: the packing entry point ------------------------------

def _example_part1():
    """examples/pack_and_report.py Part 1's numbers, on the reference."""
    rows = {}
    for make_arch, label in ((jcore.d_imc, "d_imc"), (jcore.a_imc, "a_imc")):
        for wl in jcore.mlperf_tiny_suite():
            budget = jcore.pack(wl, make_arch(1, 1), bounded=False).min_D_m
            arch = make_arch(1, budget)
            plans = {"packed": jcore.pack(wl, arch, bounded=True),
                     "stacked": jcore.stacked_plan(wl, arch, bounded=True),
                     "flattened": jcore.flattened_plan(wl, arch,
                                                       bounded=True)}
            edp0 = jcore.plan_cost(plans["packed"]).edp_pj_s
            for m, plan in plans.items():
                edp = jcore.plan_cost(plan).edp_pj_s
                rows[f"pack/paper/{label}/{wl.name}/{m}"] = {
                    "min_D_m": budget if m == "packed" else None,
                    "EDP_pJs": edp, "EDP_vs_packed": edp / edp0,
                    "streamed": len(plan.streamed_layers)}
    return rows


def test_pack_entry_point_on_cpu_matches_reference():
    """``python -m repro_torch.launch.pack --device cpu``: the structural
    rows equal bench_kernels' and the example's, every end-to-end row is
    within check()'s 1e-3, and it ends in ok."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tpack.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[-1] == "ok"
    rows = {r["name"]: r for r in map(json.loads, lines[:-1])}
    for name, mats in (("whisper_tiny_blocks", bk.whisper_mats()),
                       ("rwkv6_mixers", bk.rwkv_mixer_mats()),
                       ("lora_adapters_48x48", bk.lora_adapter_mats())):
        assert rows[f"kernels/canvas/{name}"] == bk.canvas_case(name, mats)
    part1 = _example_part1()
    assert {n: {k: v for k, v in r.items() if k != "name"}
            for n, r in rows.items() if n.startswith("pack/paper/")} == part1
    # Part 2a, as the example computes it
    wl = jcore.lm_workload(jget("whisper-tiny"), seq_len=64)
    budget = jcore.pack(wl, jcore.d_imc(4, 1), bounded=False).min_D_m
    plan = jcore.pack(wl, jcore.d_imc(4, budget), bounded=True)
    assert rows["pack/lm/whisper-tiny"] == {
        "name": "pack/lm/whisper-tiny", "layers": len(wl.layers),
        "min_D_m": budget, "EDP_pJs": jcore.plan_cost(plan).edp_pj_s,
        **plan.utilization_summary()}
    # Part 2b's layout
    jl = jmx.pack_canvas(bk.whisper_mats())
    r = rows["pack/canvas/whisper-tiny"]
    assert (r["matrices"], r["blocks"], r["naive_blocks"], r["density"]) == \
        (24, jl.num_blocks, 432, jl.density)
    assert r["layer0_pass_max_err"] < 1e-3
    ends = [r for r in rows.values() if "max_err_vs_per_matrix" in r]
    assert {r["precision"] for r in ends} == {"f32", "int8", "int4"}
    assert all(r["max_err_vs_per_matrix"] < 1e-3 for r in ends)
