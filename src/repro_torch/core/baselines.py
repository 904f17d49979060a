"""Baseline weight mappings from literature (paper Fig. 7).

*Stacked* (as in the multi-tiled ST accelerator [7]): the §3.1 uniform tile
pool is kept, but no 2-D packing is applied — each tile gets its own exclusive
D_m slab (only its T_i x T_o footprint of the plane is used; the rest of the
slab is wasted). Copies spread across macros round-robin.

*Flattened*: each layer's weight matrix is spread over the full D_i x D_o
plane (non-uniform edge blocks allowed), folded into D_m slabs when the plane
overflows; every slab is layer-exclusive. Dense *within* large layers, but
edge slabs and small layers still burn whole D_m slots, and reduction splits
across slabs force temporal partial-sum accumulation.

Both are expressed as PackingPlans (degenerate one-tile columns) so
`cost_model` treats all three methods identically.
"""

from __future__ import annotations

import dataclasses
import math

from .allocation import Allocation
from .columns import Column, Placement
from .imc_arch import IMCArchitecture
from .loops import LayerSpec, Workload
from .packer import PackingPlan
from .supertiles import SuperTile, TileInstance
from .tiles import Tile, generate_tile_pool


def _single_tile_column(inst: TileInstance, arch: IMCArchitecture) -> Column:
    st = SuperTile(members=(inst,))
    return Column(placements=(Placement(st, 0, 0),),
                  D_i=arch.macro.D_i, D_o=arch.macro.D_o)


def _spill_until_fit(workload: Workload, heights: dict[str, int],
                     arch: IMCArchitecture, bounded: bool) -> set[str]:
    """Greedy per-inference spill: drop largest layers until total stack
    height fits the aggregate D_h * D_m capacity."""
    streamed: set[str] = set()
    if not bounded:
        return streamed
    cap = arch.D_m * arch.D_h
    layers = sorted(workload.layers, key=lambda l: -l.weight_volume)
    i = 0
    while (sum(h for n, h in heights.items() if n not in streamed) > cap
           and i < len(layers)):
        streamed.add(layers[i].name)
        i += 1
    return streamed


def _build_plan(workload: Workload, arch: IMCArchitecture,
                tiles: dict[str, Tile], streamed: set[str],
                method: str) -> PackingPlan:
    """Round-robin single-tile columns across macros, stacking vertically."""
    macros: list[list[Column]] = [[] for _ in range(arch.D_h)]
    used = [0] * arch.D_h
    rr = 0
    for layer in workload.layers:
        if layer.name in streamed:
            continue
        t = tiles[layer.name]
        for c in range(t.T_h):
            col = _single_tile_column(TileInstance(tile=t, copy=c), arch)
            macros[rr % arch.D_h].append(col)
            used[rr % arch.D_h] += t.T_m
            rr += 1
    alloc = Allocation(macros=tuple(tuple(m) for m in macros),
                       min_D_m=max(used) if any(used) else 0)
    return PackingPlan(workload=workload, arch=arch, tiles=tiles,
                       columns=tuple(c for m in macros for c in m),
                       allocation=alloc, streamed_layers=frozenset(streamed),
                       method=method)


def stacked_plan(workload: Workload, arch: IMCArchitecture, *,
                 bounded: bool = True) -> PackingPlan:
    tiles = {t.layer.name: t for t in generate_tile_pool(workload.layers, arch)}
    heights = {n: t.T_m * t.T_h for n, t in tiles.items()}
    streamed = _spill_until_fit(workload, heights, arch, bounded)
    return _build_plan(workload, arch, tiles, streamed, "stacked")


def flattened_plan(workload: Workload, arch: IMCArchitecture, *,
                   bounded: bool = True) -> PackingPlan:
    """Full-plane slabs per layer, expressed as padded tiles.

    Geometry: ceil(K/D_i) row-blocks x ceil(red/D_o) reduction-blocks; the
    row-blocks spread across up to D_h macros (independent outputs run in
    parallel), the rest fold temporally into D_m. Padding (edge slabs) is
    charged as occupied memory; compute energy is activity-scaled in the cost
    model (digital arrays clock-gate idle cells).
    """
    m = arch.macro
    tiles: dict[str, Tile] = {}
    heights: dict[str, int] = {}
    for layer in workload.layers:
        k_blocks = math.ceil(layer.K / m.D_i)
        r_blocks = math.ceil(layer.reduction / m.D_o)
        k_spatial = min(k_blocks, arch.D_h)
        k_temporal = math.ceil(k_blocks / k_spatial)
        t_i = min(layer.K, m.D_i)
        t_o = min(layer.reduction, m.D_o)
        t_m = k_temporal * r_blocks
        tiles[layer.name] = _padded_tile(layer, t_i, t_o, t_m,
                                         k_spatial, r_blocks)
        heights[layer.name] = t_m * k_spatial
    streamed = _spill_until_fit(workload, heights, arch, bounded)
    return _build_plan(workload, arch, tiles, streamed, "flattened")


def _padded_tile(layer: LayerSpec, t_i: int, t_o: int, t_m: int,
                 t_h: int, r_blocks: int) -> Tile:
    """Tile whose bounding box may overshoot the true weight volume (edge-slab
    waste). Tile invariants demand exactness, so geometry is carried by a
    padded pseudo-spec that keeps the original OX/OY (latency) while the cost
    model keeps charging the *original* layer's activations/outputs."""
    k_temporal = t_m // r_blocks
    padded = dataclasses.replace(
        layer, K=t_i * t_h * k_temporal, C=t_o * r_blocks, FX=1, FY=1,
        groups=1)
    return Tile(layer=padded, T_i=t_i, T_o=t_o, T_m=t_m, T_h=t_h,
                T_m_red=r_blocks, T_h_red=1)
