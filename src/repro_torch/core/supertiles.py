"""§3.2 SuperTile generation.

Supertiles stack tiles of *different* layers (<= 1 tile per layer per stack)
along the D_m dimension, without rotation, like the "superitems" of
Elhedhli et al. [8]. Constraints from the paper:

  (1) at most one tile per layer in a stack (keeps each layer's spatial
      parallelism intact),
  (2) cumulative height sum(T_m) <= max T_m over the original tile pool
      (lossless search-speed heuristic).

A supertile's plane footprint is ST_i x ST_o (max over members); its height
ST_m is the sum of member heights.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from .tiles import Tile


@dataclasses.dataclass(frozen=True)
class TileInstance:
    """One of the T_h copies of a layer's tile (copies go to distinct macros)."""

    tile: Tile
    copy: int

    @property
    def layer_name(self) -> str:
        return self.tile.layer.name

    @property
    def key(self) -> tuple[str, int]:
        return (self.layer_name, self.copy)


@dataclasses.dataclass(frozen=True)
class SuperTile:
    """A D_m-stack of tile instances from distinct layers."""

    members: tuple[TileInstance, ...]

    def __post_init__(self) -> None:
        layers = [m.layer_name for m in self.members]
        if len(set(layers)) != len(layers):
            raise ValueError("supertile stacks must hold distinct layers")

    @property
    def ST_i(self) -> int:
        return max(m.tile.T_i for m in self.members)

    @property
    def ST_o(self) -> int:
        return max(m.tile.T_o for m in self.members)

    @property
    def ST_m(self) -> int:
        return sum(m.tile.T_m for m in self.members)

    @property
    def volume(self) -> int:
        """True weight volume held (NOT the bounding box)."""
        return sum(m.tile.volume for m in self.members)

    @property
    def bbox_volume(self) -> int:
        return self.ST_i * self.ST_o * self.ST_m

    @property
    def layer_names(self) -> frozenset[str]:
        return frozenset(m.layer_name for m in self.members)

    @property
    def keys(self) -> frozenset[tuple[str, int]]:
        return frozenset(m.key for m in self.members)


def expand_instances(tiles: Sequence[Tile]) -> list[TileInstance]:
    """The packing pool: every tile expanded into its T_h spatial copies."""
    return [TileInstance(tile=t, copy=c) for t in tiles for c in range(t.T_h)]


def generate_supertiles(tiles: Sequence[Tile]) -> list[SuperTile]:
    """Build the supertile pool.

    We generate (a) all singletons and (b) greedy stacks over instances of
    *distinct* layers whose footprints nest (T_i and T_o both <= the base
    tile's), bounded by sum(T_m) <= max T_m of the pool. This is the paper's
    constrained (non-exhaustive) stack set; singletons guarantee that column
    generation always has a feasible pool.
    """
    if not tiles:
        return []
    instances = expand_instances(tiles)
    max_tm = max(t.T_m for t in tiles)

    pool: list[SuperTile] = [SuperTile(members=(i,)) for i in instances]

    # Greedy nested stacks: biggest footprint first as base; fill with the
    # tallest nestable instances from other layers.
    by_fp = sorted(instances, key=lambda i: (-i.tile.footprint, -i.tile.T_m,
                                             i.key))
    for bi, base in enumerate(by_fp):
        stack = [base]
        used_layers = {base.layer_name}
        height = base.tile.T_m
        for cand in by_fp[bi + 1:]:
            if cand.layer_name in used_layers:
                continue
            if cand.tile.T_i > base.tile.T_i or cand.tile.T_o > base.tile.T_o:
                continue
            if height + cand.tile.T_m > max_tm:
                continue
            stack.append(cand)
            used_layers.add(cand.layer_name)
            height += cand.tile.T_m
        if len(stack) > 1:
            pool.append(SuperTile(members=tuple(stack)))
    return pool
