"""The dry run's cells of the vlm, ssm, hybrid and encoder-decoder
families on the CPU (``launch.dryrun``, ``steps.lower_cell``: rank 0's
``meta`` shards of the (16, 16) mesh, a ``DryMesh`` counting the
collectives).

rwkv6-7b's and recurrentgemma-9b's train_4k, prefill_32k, decode_32k and
long_500k cells are traced cut in depth: rwkv6 to 0 and 2 layers,
recurrentgemma to 0 layers, 1 rec layer and one (rec, rec, attn) period,
a train cell with the full config's FSDP groups (these two have none)
and one microbatch. Each layer of a kind is the same work, so the cuts
give the figures of the embedding and head and of a layer of each kind,
and the full cell's are their sum over its layers:
- a decode and a long cell (cheap) are traced at full depth too and held
  to that sum exactly;
- a train and a prefill cell (the WKV and RG-LRU loops over 4k and 32k
  tokens take 7-25 minutes at full depth on a CPU) are held to
  ``FULL_DEPTH``, the figures ``launch.dryrun`` wrote at full depth and
  the full microbatches, which PERF.md publishes. A microbatch's rows do
  the same work in any split, so only a collective that does not move a
  row's bytes adds with the microbatches: recurrentgemma's replicated
  ``w_r``, whose gradient each backward all-reduces over the model axis
  (``_per_microbatch``).
Each records its argument bytes (the local shards'), a peak of live
bytes, FLOPs and collective bytes by kind: a serving cell's collectives
exactly ``_serve_collectives``, a train cell's all-gathers and
reduce-scatters exactly its forward's (twice under remat) and their
backward. qwen2-vl-7b's (28 heads) and whisper-tiny's (6 heads) cells
over 16 model ranks are written ``ok: false``, "cuts a head".
"""

import dataclasses
import functools
import json
import math
from fractions import Fraction

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import production_abstract_mesh
from repro_torch.models.griffin import _state_counts

#: arch -> the depths its cells are traced at
DEPTHS = {"rwkv6-7b": (0, 2), "recurrentgemma-9b": (0, 1, 3)}
CELLS = [(arch, shape) for arch in DEPTHS
         for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
TP = 16
#: FLOPs and collective bytes a chip (all-gather, all-reduce,
#: reduce-scatter; no all-to-all or permute) of the full cells, as
#: ``python -m repro_torch.launch.dryrun --arch rwkv6-7b,recurrentgemma-9b
#: --shape train_4k,prefill_32k --mesh single`` writes them
FULL_DEPTH = {
    ("rwkv6-7b", "train_4k"):
        (248213139357696, 206712078336, 192702513160, 16777216),
    ("rwkv6-7b", "prefill_32k"):
        (62603443306496, 103348699136, 34896609280, 0),
    ("recurrentgemma-9b", "train_4k"):
        (296799420022784, 29527900160, 110817869832, 922746880),
    ("recurrentgemma-9b", "prefill_32k"):
        (94764420562944, 14763950080, 41339060224, 0),
}


def _cut_config(arch, layers: int):
    return dataclasses.replace(get_config(arch), num_layers=layers)


@functools.cache
def _cut(arch, shape, layers: int):
    """(cell, record) of ``arch``'s cell cut to ``layers`` on the (16, 16)
    mesh; a train cell with the full config's FSDP groups and one
    microbatch."""
    kw = {}
    plan = steps.plan_residency
    if SHAPES[shape].kind == "train":
        full = get_config(arch)
        steps.plan_residency = lambda cfg, **k: plan(full, **k)
        kw["microbatches"] = 1
    try:
        return dryrun.trace_cell(_cut_config(arch, layers), shape, False,
                                 **kw)
    finally:
        steps.plan_residency = plan


def _figures(rec) -> dict:
    return {"flops": rec["cost"]["flops"],
            **rec["collective_bytes_per_chip"]}


def _kinds(cfg) -> tuple:
    """The layers of each kind: rwkv6 (layers,), recurrentgemma (rec,
    attn)."""
    return _state_counts(cfg) if cfg.family == "hybrid" \
        else (cfg.num_layers,)


def _solve(rows, vals) -> list:
    """The exact x of the square integer system rows @ x = vals."""
    m = [[Fraction(a) for a in (*r, v)] for r, v in zip(rows, vals)]
    for i in range(len(m)):
        p = next(j for j in range(i, len(m)) if m[j][i])
        m[i], m[p] = m[p], m[i]
        m[i] = [a / m[i][i] for a in m[i]]
        for j in range(len(m)):
            if j != i:
                m[j] = [a - m[j][i] * b for a, b in zip(m[j], m[i])]
    return [r[-1] for r in m]


def _extrapolated(arch, shape) -> dict:
    """The full cell's figures, one microbatch, from the cuts': those of
    the embedding and head and of a layer of each kind solved from the
    cuts, summed over the full config's layers."""
    cuts = [_figures(_cut(arch, shape, n)[1]) for n in DEPTHS[arch]]
    rows = [(1, *_kinds(_cut_config(arch, n))) for n in DEPTHS[arch]]
    full = (1, *_kinds(get_config(arch)))
    out = {}
    for k in cuts[0]:
        x = _solve(rows, [c[k] for c in cuts])
        n = sum(a * b for a, b in zip(full, x))
        assert n.denominator == 1, (k, n)
        out[k] = int(n)
    return out


def _per_microbatch(cfg) -> int:
    """The all-reduce bytes a chip each microbatch past the first adds:
    recurrentgemma's replicated ``w_r`` (lru width square, bf16 in the
    compute view), whose columns a rank uses behind ``copy_to_tp``, has
    its gradient all-reduced over the model axis in each backward."""
    if cfg.family != "hybrid":
        return 0
    return _state_counts(cfg)[0] * cfg.recurrent.lru_width ** 2 * 2


def _local_bytes(tree, specs, mesh) -> int:
    return sum(math.prod(sh.local_shape(t.shape, sh.leaf_at(specs, path),
                                        mesh)) * t.element_size()
               for path, t in sh.flatten(tree)
               if isinstance(t, torch.Tensor) and t.is_meta)


def _gathers(cfg, rows: int, seq: int) -> tuple[int, int]:
    """(all-gather bytes, the part of them ``gather_from_tp`` moves) of a
    forward over ``seq`` tokens of ``rows`` rows a chip, bf16. rwkv6: a
    layer's two token-shift registers (a row each), and a token's five
    ddlerp streams and channel-mix gate, each whole over D, and its decay
    lora's 64 columns (``gather_from_tp``: its backward reduce-scatters,
    the others' keep the rank's slice). recurrentgemma: a rec layer's
    conv output (lru width) and an attn layer's cut K and V head (dh 256
    each), all ``gather_from_tp``."""
    if cfg.family == "ssm":
        D, n = cfg.d_model, cfg.num_layers
        split = n * rows * seq * 64 * 2
        return n * rows * (2 * D + seq * 6 * D) * 2 + split, split
    n_rec, n_attn = _state_counts(cfg)
    split = (n_rec * cfg.recurrent.lru_width
             + n_attn * 2 * cfg.head_dim) * rows * seq * 2
    return split, split


def _serve_collectives(cfg, rows: int, seq: int) -> dict:
    """The collective bytes a chip of a serving pass (a prefill, or a
    decode step at ``seq`` 1) over ``seq`` tokens of ``rows`` rows: the
    embedding's all-reduce and a layer's two row-parallel all-reduces a
    token, and the gathers (``_gathers``)."""
    reduce = (2 * cfg.num_layers + 1) * rows * seq * cfg.d_model * 2
    return {"all-gather": _gathers(cfg, rows, seq)[0], "all-reduce": reduce,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}


def _check_collectives(cfg, shape, coll) -> None:
    """A serving cell's collectives exactly ``_serve_collectives`` (128
    rows over 16 data ranks a decode cell, 32 a prefill, long_500k's one
    row on every chip); a train cell's all-gathers twice its forward's
    (remat runs each block's again), its reduce-scatters the
    ``gather_from_tp`` part of them over the model axis, once."""
    s = SHAPES[shape]
    rows = s.global_batch // 16 or 1
    if s.kind == "train":
        gather, split = _gathers(cfg, rows, s.seq_len)
        assert (coll["all-gather"], coll["reduce-scatter"]) == \
            (2 * gather, split // TP), coll
        assert coll["all-to-all"] == coll["collective-permute"] == 0
    else:
        seq = 1 if s.kind == "decode" else s.seq_len
        assert coll == _serve_collectives(cfg, rows, seq), coll


@pytest.mark.parametrize("arch,shape", CELLS, ids=str)
def test_dryrun_family_cells_trace(arch, shape):
    """rwkv6-7b's and recurrentgemma-9b's cells on the (16, 16) mesh,
    traced at their deepest cut: each on rank 0's shards with the
    argument bytes of its local shards (a train cell's split into params,
    m, v and batch), FLOPs and a peak of live bytes; its collectives
    exactly as ``_check_collectives`` counts them, a train cell's
    all-reduces at least its gradients' bytes; a decode cell's logits the
    rank's vocabulary columns."""
    cell, rec = _cut(arch, shape, DEPTHS[arch][-1])
    cfg, mesh = cell.cfg, production_abstract_mesh()
    assert rec["ok"] and rec["kind"] == SHAPES[shape].kind, rec
    want = sum(_local_bytes(a, s, mesh)
               for a, s in zip(cell.args, cell.in_pspecs))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_live_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    coll = rec["collective_bytes_per_chip"]
    _check_collectives(cfg, shape, coll)
    if cell.kind == "decode":
        rows = SHAPES[shape].global_batch // 16 or 1
        assert rec["memory"]["output_bytes"] >= \
            rows * cfg.vocab_size // TP * 4
    elif cell.kind == "train":
        params, p_spec = cell.args[0], cell.in_pspecs[0]
        parts = rec["memory"]["argument_parts_bytes"]
        p_bytes = _local_bytes(params, p_spec, mesh)
        assert parts["params"] == parts["m"] == parts["v"] == p_bytes
        assert not [path for path, _ in sh.flatten(params)
                    if sh.fsdp_dim(sh.leaf_at(p_spec, path)) is not None]
        assert coll["all-reduce"] >= p_bytes


@pytest.mark.parametrize("arch,shape", CELLS, ids=str)
def test_dryrun_family_cells_extrapolate_to_full_depth(arch, shape):
    """The full cell's FLOPs and collective bytes are the cuts' per-layer
    figures summed over its layers (``_extrapolated``): a decode and a
    long cell's equal to their full-depth trace (``run_cell``, as the dry
    run writes it); a train and a prefill cell's to ``FULL_DEPTH``, a
    train cell's with its full microbatches' ``_per_microbatch``
    all-reduces. Their collectives count as ``_check_collectives`` says
    at full depth too."""
    got = _extrapolated(arch, shape)
    cfg = get_config(arch)
    if SHAPES[shape].kind == "decode":
        rec = dryrun.run_cell(arch, shape, False)
        assert rec["ok"], rec
        assert got == _figures(rec)
    else:
        if SHAPES[shape].kind == "train":
            mb = steps.default_microbatches(cfg, SHAPES[shape],
                                            production_abstract_mesh())
            got["all-reduce"] += (mb - 1) * _per_microbatch(cfg)
        flops, gather, reduce, scatter = FULL_DEPTH[arch, shape]
        assert got == {"flops": flops, "all-gather": gather,
                       "all-reduce": reduce, "reduce-scatter": scatter,
                       "all-to-all": 0, "collective-permute": 0}
    _check_collectives(cfg, shape, {k: got[k] for k in KINDS})


def test_dryrun_refuses_the_cells_that_cut_a_head(tmp_path):
    """qwen2-vl-7b's 28 heads and whisper-tiny's 6 over the 16 model
    ranks: each of their cells is written ``ok: false``, "cuts a head"
    (reshard around attention waits for a later slice)."""
    assert dryrun.main(["--arch", "qwen2-vl-7b,whisper-tiny", "--shape",
                        "all", "--mesh", "single", "--out",
                        str(tmp_path)]) == 1
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 6
    for r in recs:
        assert not r["ok"] and "cuts a head" in r["error"], r
