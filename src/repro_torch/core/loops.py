"""Loop-nest description of DNN layers and loop-prime-factor (LPF) machinery.

The paper (§2.1) describes every layer as a 6-nested loop over
(K, C, FX, FY, OX, OY):

    for k in K:                 # output channels      -> weight + output relevant
      for c in C:               # input channels       -> weight + input relevant
        for fx in FX:           # filter x             -> weight + input relevant
          for fy in FY:         # filter y             -> weight + input relevant
            for ox in OX:       # output x             -> activation-only (temporal)
              for oy in OY:     # output y             -> activation-only (temporal)
                O[k,ox,oy] += W[k,c,fx,fy] * I[c, ox*s+fx, oy*s+fy]

The IMC weight-stationary dataflow (paper Fig. 2b) unrolls:
  * K            across D_i  (input-reuse rows: the same input is broadcast
                              to all K multipliers in a column),
  * C, FX, FY    across D_o  (output-reuse: partial sums accumulate in-array),
  * leftovers    across D_h  (macro-level spatial) then D_m (temporal multiplex).

LPFs ("loop prime factors", after ZigZag [16]) are the prime factors of each
loop bound; mapping = assigning every LPF to one of {T_i, T_o, T_h, T_m}.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Iterable, Mapping, Sequence

# Loop names. K is *input-irrelevant* (unrolled on D_i); C/FX/FY are
# *output-irrelevant* (unrolled on D_o); OX/OY are never weight-relevant and
# always run temporally outside the array.
K, C, FX, FY, OX, OY = "K", "C", "FX", "FY", "OX", "OY"
WEIGHT_LOOPS = (K, C, FX, FY)
INPUT_RELEVANT = (C, FX, FY)  # prioritized on D_h by §3.1 (spatial psum reuse)
OUTPUT_RELEVANT = (K,)


def prime_factors(n: int) -> tuple[int, ...]:
    """Prime factorization of ``n`` as a sorted tuple (with multiplicity)."""
    if n < 1:
        raise ValueError(f"loop bound must be >= 1, got {n}")
    out: list[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


def best_subproduct(factors: Sequence[int], cap: int) -> tuple[int, tuple[int, ...]]:
    """Largest product of a sub-multiset of ``factors`` that is <= cap.

    Exact dynamic program over achievable products (small: products bounded by
    cap, factor lists are short for real layer dims). Returns
    ``(best_product, chosen_factors)``.
    """
    if cap < 1:
        return 1, ()
    # Map achievable product -> chosen multiset (as sorted tuple).
    best: dict[int, tuple[int, ...]] = {1: ()}
    for f in factors:
        updates: dict[int, tuple[int, ...]] = {}
        for prod, chosen in best.items():
            np_ = prod * f
            if np_ <= cap and np_ not in best and np_ not in updates:
                updates[np_] = tuple(sorted((*chosen, f)))
        best.update(updates)
    bp = max(best)
    return bp, best[bp]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One DNN layer as its 6-loop nest (weights: K x C x FX x FY)."""

    name: str
    K: int
    C: int
    FX: int = 1
    FY: int = 1
    OX: int = 1
    OY: int = 1
    groups: int = 1  # depthwise/grouped conv: weight volume counts C per group

    def __post_init__(self) -> None:
        for f in ("K", "C", "FX", "FY", "OX", "OY", "groups"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{self.name}: {f} must be a positive int, got {v!r}")
        if self.K % self.groups or self.C % self.groups:
            raise ValueError(f"{self.name}: K and C must divide groups")

    @property
    def bounds(self) -> dict[str, int]:
        return {K: self.K, C: self.C, FX: self.FX, FY: self.FY,
                OX: self.OX, OY: self.OY}

    @property
    def weight_volume(self) -> int:
        """Number of weight elements (grouped convs store C/groups per filter)."""
        return self.K * (self.C // self.groups) * self.FX * self.FY

    @property
    def macs(self) -> int:
        return self.weight_volume * self.OX * self.OY

    @property
    def reduction(self) -> int:
        """Elements accumulated per output (C/g * FX * FY) — the D_o extent."""
        return (self.C // self.groups) * self.FX * self.FY

    def lpfs(self, loop: str) -> tuple[int, ...]:
        """LPFs of one weight loop. For grouped convs the C loop uses C/groups
        (each output channel only reduces over its own group)."""
        bound = self.bounds[loop]
        if loop == C:
            bound = self.C // self.groups
        return prime_factors(bound)

    @staticmethod
    def fc(name: str, in_features: int, out_features: int, *,
           ox: int = 1, oy: int = 1) -> "LayerSpec":
        """Fully-connected layer: K=out, C=in, 1x1 'filter'. ``ox`` can carry a
        batch/sequence dimension (each output position is one MVM)."""
        return LayerSpec(name=name, K=out_features, C=in_features, OX=ox, OY=oy)

    @staticmethod
    def conv2d(name: str, in_ch: int, out_ch: int, kernel: int | tuple[int, int],
               out_hw: tuple[int, int], *, groups: int = 1) -> "LayerSpec":
        kx, ky = (kernel, kernel) if isinstance(kernel, int) else kernel
        return LayerSpec(name=name, K=out_ch, C=in_ch, FX=kx, FY=ky,
                         OX=out_hw[0], OY=out_hw[1], groups=groups)


@dataclasses.dataclass(frozen=True)
class Workload:
    """An inference workload = ordered sequence of layers."""

    name: str
    layers: tuple[LayerSpec, ...]

    def __post_init__(self) -> None:
        names = [l.name for l in self.layers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate layer names in workload {self.name}")

    @property
    def total_weight_volume(self) -> int:
        return sum(l.weight_volume for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    def layer(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


def product(xs: Iterable[int]) -> int:
    return functools.reduce(lambda a, b: a * b, xs, 1)
