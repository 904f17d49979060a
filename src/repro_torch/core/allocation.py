"""§3.4 Column allocation to macros (+ the folding fallback loop).

Columns are bin-packed 1-D along D_m into the D_h macros, under the
compute-utilization constraint: *at most one tile of a layer per macro*
(tiles of the same layer spread across D_h so they run in parallel).

If the columns do not fit in D_h x D_m, the *folding* strategy (§3.4) demotes
one spatial LPF of the lowest-latency layer into T_m and the whole pipeline
(tiles -> supertiles -> columns -> allocation) is re-run. If no layer can be
folded any further the packing is infeasible at this (D_h, D_m) and callers
fall back to DRAM-streaming of the largest layers (cost_model charges the
per-inference reload).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from .columns import Column
from .imc_arch import IMCArchitecture


@dataclasses.dataclass
class Macro:
    index: int
    capacity: int  # D_m
    columns: list[Column] = dataclasses.field(default_factory=list)

    @property
    def used(self) -> int:
        return sum(c.height for c in self.columns)

    @property
    def layer_names(self) -> set[str]:
        out: set[str] = set()
        for c in self.columns:
            out |= c.layer_names
        return out

    def fits(self, col: Column) -> bool:
        return (self.used + col.height <= self.capacity
                and not (self.layer_names & col.layer_names))


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Result of the 1-D bin packing across D_h macros."""

    macros: tuple[tuple[Column, ...], ...]  # per-macro column lists
    min_D_m: int                            # tallest macro occupancy

    def macro_of_layer(self, layer_name: str) -> list[int]:
        out = []
        for i, cols in enumerate(self.macros):
            if any(layer_name in c.layer_names for c in cols):
                out.append(i)
        return out


def allocate_columns(columns: Sequence[Column], arch: IMCArchitecture,
                     *, capacity: int | None = None) -> Allocation | None:
    """First-fit-decreasing with the layer-disjointness constraint.

    ``capacity=None`` means unbounded D_m (used to compute the *minimum
    required* D_m, the paper's Fig. 8 metric). Returns None if packing is
    impossible (capacity exceeded or layer constraint unsatisfiable).
    """
    cap = capacity if capacity is not None else 1 << 62
    macros = [Macro(index=i, capacity=cap) for i in range(arch.D_h)]
    for col in sorted(columns, key=lambda c: (-c.height, -c.volume)):
        # Choose the feasible macro with the *most* remaining headroom after
        # placement (best-fit for layer spreading: prefer emptier macros so
        # copies of a layer land on distinct macros naturally).
        feas = [m for m in macros if m.fits(col)]
        if not feas:
            return None
        target = min(feas, key=lambda m: (m.used, m.index))
        target.columns.append(col)
    return Allocation(
        macros=tuple(tuple(m.columns) for m in macros),
        min_D_m=max((m.used for m in macros), default=0),
    )
