"""§3.1 Tile generation.

For each layer we derive one uniform tile shape ``T_i x T_o x T_m`` with
``T_h`` spatial copies:

  * T_i = LPF sub-product of K maximizing utilization of D_i,
  * T_o = LPF sub-product of C*FX*FY maximizing utilization of D_o,
  * leftover LPFs go to T_h (spatial, capped at D_h; *input-relevant* LPFs
    C/FX/FY prioritized — they give spatial partial-sum reuse) then to T_m
    (temporal multiplexing).

Invariant:  T_i * T_o * T_h * T_m == layer.weight_volume.

Tiles additionally track how much of T_m / T_h comes from *reduction*
(input-relevant) loops: reduction steps multiplexed in time force partial-sum
read-modify-writes, while K steps multiplexed in time keep inputs stationary
(§3.4's folding-priority rationale). The cost model depends on this split.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from .imc_arch import IMCArchitecture
from .loops import (C, FX, FY, K, LayerSpec, best_subproduct, prime_factors,
                    product)


@dataclasses.dataclass(frozen=True)
class Tile:
    """A uniform weight tile of one layer.

    T_i rows (K), T_o cols (reduction), T_m temporal depth; the layer has
    ``T_h`` identical copies to spread across macros. ``T_m_red`` / ``T_h_red``
    are the reduction-loop (input-relevant) sub-products of T_m / T_h.
    ``folds`` counts §3.4 folding steps applied.
    """

    layer: LayerSpec
    T_i: int
    T_o: int
    T_m: int
    T_h: int
    T_m_red: int = 1
    T_h_red: int = 1
    folds: int = 0

    def __post_init__(self) -> None:
        if self.T_i * self.T_o * self.T_m * self.T_h != self.layer.weight_volume:
            raise ValueError(
                f"{self.layer.name}: tile {self.T_i}x{self.T_o}x{self.T_m}"
                f"(xT_h={self.T_h}) != weight volume {self.layer.weight_volume}")
        if self.T_m % self.T_m_red or self.T_h % self.T_h_red:
            raise ValueError(f"{self.layer.name}: relevance split must divide")
        if self.T_o * self.T_m_red * self.T_h_red != self.layer.reduction:
            raise ValueError(
                f"{self.layer.name}: reduction split inconsistent: "
                f"{self.T_o}*{self.T_m_red}*{self.T_h_red} != "
                f"{self.layer.reduction}")

    @property
    def footprint(self) -> int:
        """Occupied multiplier positions in the D_i x D_o plane."""
        return self.T_i * self.T_o

    @property
    def volume(self) -> int:
        """Weight elements held by ONE copy of this tile."""
        return self.T_i * self.T_o * self.T_m

    @property
    def name(self) -> str:
        return self.layer.name

    @property
    def T_m_k(self) -> int:
        """K-loop (output-relevant) part of T_m — input-stationary steps."""
        return self.T_m // self.T_m_red

    def compute_cycles(self) -> int:
        """MVM cycles to execute the layer with this tiling: the OX/OY loops
        run temporally, and each D_m slot is visited once per output step."""
        return self.layer.OX * self.layer.OY * self.T_m

    def spatial_parallelism(self) -> int:
        """Active MACs per cycle across all T_h copies."""
        return self.T_i * self.T_o * self.T_h


def generate_tile(layer: LayerSpec, arch: IMCArchitecture) -> Tile:
    """§3.1 — build the initial uniform tile for one layer."""
    macro = arch.macro

    # Step (c): T_i from K's LPFs maximizing D_i utilization.
    t_i, used_k = best_subproduct(layer.lpfs(K), macro.D_i)
    # T_o from C/FX/FY LPFs maximizing D_o utilization.
    red_lpfs = layer.lpfs(C) + layer.lpfs(FX) + layer.lpfs(FY)
    t_o, used_red = best_subproduct(red_lpfs, macro.D_o)

    # Leftover LPFs, tagged by relevance for the T_h priority rule.
    left_k = _remove(layer.lpfs(K), used_k)              # output-relevant
    left_red = _remove(red_lpfs, used_red)               # input-relevant

    # Step (c) cont.: maximize T_h <= D_h, input-relevant LPFs first.
    t_h_red, used_h_in = best_subproduct(left_red, arch.D_h)
    left_red = _remove(left_red, used_h_in)
    t_h_k, used_h_out = best_subproduct(left_k, arch.D_h // t_h_red)
    left_k = _remove(left_k, used_h_out)

    # Step (d): everything else is temporally multiplexed in T_m.
    t_m_red = product(left_red)
    t_m_k = product(left_k)
    return Tile(layer=layer, T_i=t_i, T_o=t_o,
                T_m=t_m_k * t_m_red, T_h=t_h_red * t_h_k,
                T_m_red=t_m_red, T_h_red=t_h_red)


def generate_tile_pool(layers: Sequence[LayerSpec],
                       arch: IMCArchitecture) -> list[Tile]:
    return [generate_tile(l, arch) for l in layers]


def fold_tile(tile: Tile) -> Tile | None:
    """§3.4 folding — demote one spatial LPF to the temporal T_m dimension.

    K-side (T_i) LPFs are prioritized ("folding of K_u loops ... cause temporal
    stationarity for the inputs"); the smallest available LPF is folded.
    Returns None when the tile cannot be folded further.
    """
    if tile.T_i > 1:
        lpf = min(prime_factors(tile.T_i))
        return dataclasses.replace(
            tile, T_i=tile.T_i // lpf, T_m=tile.T_m * lpf,
            folds=tile.folds + 1)
    if tile.T_o > 1:
        lpf = min(prime_factors(tile.T_o))
        return dataclasses.replace(
            tile, T_o=tile.T_o // lpf, T_m=tile.T_m * lpf,
            T_m_red=tile.T_m_red * lpf, folds=tile.folds + 1)
    return None


def _remove(factors: Sequence[int], used: Sequence[int]) -> tuple[int, ...]:
    pool = list(factors)
    for u in used:
        pool.remove(u)
    return tuple(pool)
