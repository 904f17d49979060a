"""§3.3 Column generation.

A *column* is a dense allocation of supertiles in the D_i x D_o plane of one
macro, of height ST_m_max (the tallest member). Columns are generated
iteratively: pack a subset of supertiles (layers pairwise distinct), score its
density

    density = sum(tile volumes) / (D_i * D_o * ST_m_max),

keep the densest, remove its tiles from the pool, repeat until empty.

The 2-D packer is a deterministic shelf packer over the (D_i rows, D_o cols)
plane; it returns concrete (row, col) placements which are reused verbatim by
the TPU `packed_canvas` kernel layout (planner/mxu_pack.py).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

from .imc_arch import IMCArchitecture
from .supertiles import SuperTile, TileInstance, expand_instances, generate_supertiles
from .tiles import Tile


@dataclasses.dataclass(frozen=True)
class Placement:
    """A supertile placed at (row, col) in the plane, occupying
    [row, row+ST_i) x [col, col+ST_o) and D_m depth [0, ST_m)."""

    supertile: SuperTile
    row: int
    col: int


@dataclasses.dataclass(frozen=True)
class Column:
    placements: tuple[Placement, ...]
    D_i: int
    D_o: int

    @property
    def height(self) -> int:
        return max(p.supertile.ST_m for p in self.placements)

    @property
    def volume(self) -> int:
        return sum(p.supertile.volume for p in self.placements)

    @property
    def density(self) -> float:
        return self.volume / (self.D_i * self.D_o * self.height)

    @property
    def layer_names(self) -> frozenset[str]:
        out: set[str] = set()
        for p in self.placements:
            out |= p.supertile.layer_names
        return frozenset(out)

    @property
    def keys(self) -> frozenset[tuple[str, int]]:
        out: set[tuple[str, int]] = set()
        for p in self.placements:
            out |= p.supertile.keys
        return frozenset(out)


class ShelfPacker:
    """Deterministic shelf packing of rectangles into a D_i x D_o plane.

    Shelves stack along D_i (rows); items sit side-by-side along D_o (cols).
    Items must be offered tallest-first for good density (callers sort).
    """

    def __init__(self, D_i: int, D_o: int):
        self.D_i, self.D_o = D_i, D_o
        self.shelves: list[list[int]] = []  # [row_off, shelf_height, col_used]
        self.row_used = 0

    def try_place(self, h: int, w: int) -> tuple[int, int] | None:
        """Place an h(rows) x w(cols) rect; returns (row, col) or None."""
        if w > self.D_o or h > self.D_i:
            return None
        for shelf in self.shelves:
            row_off, sh, used = shelf
            if h <= sh and used + w <= self.D_o:
                shelf[2] += w
                return (row_off, used)
        if self.row_used + h <= self.D_i:
            row = self.row_used
            self.shelves.append([row, h, w])
            self.row_used += h
            return (row, 0)
        return None


def _pack_greedy(seed: SuperTile, pool: Sequence[SuperTile],
                 D_i: int, D_o: int) -> Column | None:
    """Greedily grow a column from ``seed``: add supertiles of unused layers,
    largest volume first, never exceeding the seed's height (so density's
    denominator stays fixed)."""
    packer = ShelfPacker(D_i, D_o)
    pos = packer.try_place(seed.ST_i, seed.ST_o)
    if pos is None:
        return None
    placements = [Placement(seed, *pos)]
    used_keys = set(seed.keys)
    used_layers = set(seed.layer_names)

    for cand in sorted(pool, key=lambda s: (-s.volume, -s.ST_m,
                                            sorted(s.keys))):
        if cand.ST_m > seed.ST_m:
            continue
        if cand.layer_names & used_layers:
            continue
        if cand.keys & used_keys:
            continue
        pos = packer.try_place(cand.ST_i, cand.ST_o)
        if pos is None:
            continue
        placements.append(Placement(cand, *pos))
        used_keys |= cand.keys
        used_layers |= cand.layer_names
    return Column(placements=tuple(placements), D_i=D_i, D_o=D_o)


def generate_columns(tiles: Sequence[Tile], arch: IMCArchitecture,
                     *, seeds_to_try: int = 4) -> list[Column]:
    """Iteratively emit densest columns until all tile instances are packed."""
    macro = arch.macro
    remaining = set(inst.key for inst in expand_instances(tiles))
    columns: list[Column] = []

    while remaining:
        pool = [st for st in generate_supertiles(tiles)
                if st.keys <= remaining]
        # Try a few seeds (tallest supertiles of distinct heights first).
        seeds: list[SuperTile] = []
        seen_h: set[int] = set()
        for st in sorted(pool, key=lambda s: (-s.ST_m, -s.volume,
                                              sorted(s.keys))):
            if st.ST_m not in seen_h:
                seeds.append(st)
                seen_h.add(st.ST_m)
            if len(seeds) >= seeds_to_try:
                break
        best: Column | None = None
        for seed in seeds:
            col = _pack_greedy(seed, [s for s in pool if s is not seed],
                               macro.D_i, macro.D_o)
            if col and (best is None or col.density > best.density):
                best = col
        if best is None:  # cannot happen: singletons always fit a macro plane
            raise RuntimeError("column generation failed to place any tile")
        columns.append(best)
        remaining -= best.keys
    return columns
