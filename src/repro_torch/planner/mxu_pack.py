"""Weight packing -> virtual-plane layout for the packed_canvas kernel.

A copy of the JAX package's ``planner/mxu_pack.py`` whose array-making methods
return torch tensors on an explicit device; the layouts (R, C,
placements, block cover, meta) are the reference's, so its packed blocks
carry across one to one.

The paper packs weight tiles into the D_i x D_o multiplier plane of IMC
macros, overflowing into the D_m cell depth. The TPU analogue places every
small weight matrix into one *virtual* plane

    rows  (R) = concatenation of distinct input vectors   (D_i reuse)
    cols  (C) = concatenation of tile output ranges       (D_o)

and stores only the 128x128 MXU blocks that intersect a tile, compacted
into ``w_blocks (G, 128, 128)`` — the D_m capacity axis become a block
list. Both of the paper's objectives collapse into one number here:

    density = sum(tile volumes) / (G * 128 * 128)

fewer blocks = less memory held AND fewer MXU passes, since the kernel
visits exactly the block list. Placement is deliberately *unaligned*:
matrices sharing an input (share_group — fused QKV, gate+up) share rows;
adjacent small tiles share edge blocks. Oversize matrices are chunked:
column chunks reassemble by concat (§3.1 — outputs independent along
D_o); row chunks are the paper's *folding* (§3.4) and reassemble by
summation in ``gather_outputs``.

Correctness rests on one invariant the layout maintains: a tile's row
interval holds exactly its input vector in x_packed, its column interval
belongs to it alone, and W_virtual is zero outside tiles — so the virtual
matmul computes every tile's y = x @ W independently, whatever blocks the
cover stores around them.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from ..kernels.packed_canvas import build_block_meta

BLK = 128


def _ceil(x: int, m: int = BLK) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class WeightMatrix:
    """One packable weight: y[B, cols] = x[B, rows] @ W[rows, cols].

    ``share_group``: matrices in the same group consume the same input and
    share a row interval (fused QKV / gate-up — the D_i reuse argument).
    """
    name: str
    rows: int
    cols: int
    share_group: str | None = None


@dataclasses.dataclass(frozen=True)
class ChunkPlacement:
    """One placed chunk of a matrix: W[src_row:+rows, src_col:+cols] sits
    at virtual-plane position (x_off, y_off)."""
    x_off: int
    y_off: int
    rows: int
    cols: int
    src_row: int = 0
    src_col: int = 0


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    R: int                                   # x_packed width (128-multiple)
    C: int                                   # y_packed width (128-multiple)
    placements: Mapping[str, tuple[ChunkPlacement, ...]]

    def _all(self):
        for name, chunks in self.placements.items():
            for p in chunks:
                yield name, p

    # -- block cover (what the kernel/memory actually touch) ----------------

    @functools.cached_property
    def blocks(self) -> np.ndarray:
        """(N, 2) sorted unique (kb, cb) blocks intersecting any tile.

        Cached on the instance (layouts are immutable): with pack_canvas
        memoized too, a serving config's block cover and meta are computed
        once per process lifetime."""
        s: set[tuple[int, int]] = set()
        for _, p in self._all():
            for kb in range(p.x_off // BLK, _ceil(p.x_off + p.rows) // BLK):
                for cb in range(p.y_off // BLK,
                                _ceil(p.y_off + p.cols) // BLK):
                    s.add((kb, cb))
        return np.asarray(sorted(s), np.int64).reshape(-1, 2)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def density(self) -> float:
        """The paper's packing density on MXU blocks: true weight volume
        over stored-block volume. 1.0 = perfectly packed."""
        vol = sum(p.rows * p.cols for _, p in self._all())
        return vol / (self.num_blocks * BLK * BLK)

    def block_meta(self) -> np.ndarray:
        meta, _ = build_block_meta(self.blocks)
        return meta

    # -- arrays ---------------------------------------------------------------
    # Weights and inputs may be numpy arrays or tensors on any device; the
    # results are tensors on ``device``.

    def build_w_blocks(self, weights: Mapping[str, np.ndarray],
                       dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
        """(G, 128, 128) compacted blocks in meta order, the reference's
        block for block. Each chunk is padded to its block window and
        scattered in one indexed add (tiles are disjoint, so every
        element receives one value and zeros)."""
        dev = torch.device(device)
        blocks = self.blocks
        _, order = build_block_meta(blocks)
        nkb = _ceil(self.R) // BLK
        ncb = _ceil(self.C) // BLK
        index = np.full((nkb, ncb), -1, np.int64)
        ordered = blocks[order]
        index[ordered[:, 0], ordered[:, 1]] = np.arange(len(blocks))
        out = torch.zeros((len(blocks), BLK, BLK), dtype=torch.float32,
                          device=dev)
        for name, p in self._all():
            wi = torch.as_tensor(weights[name]).to(dev, torch.float32)
            wi = wi[p.src_row:p.src_row + p.rows,
                    p.src_col:p.src_col + p.cols]
            kb0, kb1 = p.x_off // BLK, _ceil(p.x_off + p.rows) // BLK
            cb0, cb1 = p.y_off // BLK, _ceil(p.y_off + p.cols) // BLK
            win = torch.zeros(((kb1 - kb0) * BLK, (cb1 - cb0) * BLK),
                              dtype=torch.float32, device=dev)
            r0, c0 = p.x_off - kb0 * BLK, p.y_off - cb0 * BLK
            win[r0:r0 + p.rows, c0:c0 + p.cols] = wi
            win = win.view(kb1 - kb0, BLK, cb1 - cb0, BLK).permute(0, 2, 1, 3)
            idx = torch.as_tensor(index[kb0:kb1, cb0:cb1].reshape(-1),
                                  device=dev)
            out.index_add_(0, idx, win.reshape(-1, BLK, BLK))
        return out.to(dtype)

    def build_x_packed(self, inputs: Mapping[str, torch.Tensor],
                       batch: int, dtype=torch.bfloat16,
                       device="cuda") -> torch.Tensor:
        """(B, R): write each matrix's full input at its chunks' offsets.

        ``inputs[name]``: (batch, matrix.rows). Row chunks take their
        src_row slice; share-group members write identical rows.
        """
        dev = torch.device(device)
        x = torch.zeros((batch, self.R), dtype=dtype, device=dev)
        for name, p in self._all():
            xi = torch.as_tensor(inputs[name]).to(dev, dtype)
            x[:, p.x_off:p.x_off + p.rows] = \
                xi[:, p.src_row:p.src_row + p.rows]
        return x

    def gather_outputs(self, y_packed: torch.Tensor,
                       ) -> dict[str, torch.Tensor]:
        """Reassemble (B, cols) per matrix: concat column chunks, sum row
        chunks (fold accumulation)."""
        out = {}
        for name, chunks in self.placements.items():
            by_col: dict[int, list[ChunkPlacement]] = {}
            for p in chunks:
                by_col.setdefault(p.src_col, []).append(p)
            parts = []
            for src_col in sorted(by_col):
                ps = by_col[src_col]
                acc = y_packed[:, ps[0].y_off:ps[0].y_off + ps[0].cols]
                for p in ps[1:]:
                    acc = acc + y_packed[:, p.y_off:p.y_off + p.cols]
                parts.append(acc)
            out[name] = torch.cat(parts, dim=-1) if len(parts) > 1 \
                else parts[0]
        return out

    def build_w_virtual(self, weights: Mapping[str, np.ndarray],
                        dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Dense (R, C) virtual plane — oracle/debug only."""
        dev = torch.device(device)
        w = torch.zeros((self.R, self.C), dtype=dtype, device=dev)
        for name, p in self._all():
            wi = torch.as_tensor(weights[name]).to(dev, torch.float32)
            w[p.x_off:p.x_off + p.rows, p.y_off:p.y_off + p.cols] = \
                wi[p.src_row:p.src_row + p.rows,
                   p.src_col:p.src_col + p.cols].to(dtype)
        return w


def _chunk(m: WeightMatrix, max_rows: int, max_cols: int):
    """Split an oversize matrix into (rows, cols, src_row, src_col) pieces.

    Chunked matrices keep their share_group only for the first row chunk
    (later row chunks consume different input slices).
    """
    out = []
    r = 0
    while True:
        h = min(max_rows, m.rows - r)
        c = 0
        while True:
            w = min(max_cols, m.cols - c)
            out.append((h, w, r, c))
            c += w
            if c >= m.cols:
                break
        r += h
        if r >= m.rows:
            break
    return out


def _lay_out(ordered, *, mode: str) -> PackedLayout:
    """Concatenate groups along x and tiles along y.

    mode="aligned": every offset is 128-aligned (no block straddling —
    best when tiles are comparable to or larger than a block).
    mode="diagonal": tight concatenation (adjacent tiles share edge
    blocks — best when tiles are much smaller than a block).
    mode="snapped": diagonal, but a group that would straddle a block
    boundary snaps to the next block first — sub-block tiles stack
    multiple-per-block without paying 2x2 straddle covers.
    """
    placements: dict[str, list[ChunkPlacement]] = {}
    x_off = 0
    y_off = 0
    for _key, members in ordered:
        h = max(ch[0] for _, ch in members)
        w = sum(ch[1] for _, ch in members)
        if mode == "snapped":
            if x_off // BLK != (x_off + h - 1) // BLK:
                x_off = _ceil(x_off)
            if y_off // BLK != (y_off + w - 1) // BLK:
                y_off = _ceil(y_off)
        for m, (rows, cols, sr, sc) in members:
            placements.setdefault(m.name, []).append(ChunkPlacement(
                x_off=x_off, y_off=y_off, rows=rows, cols=cols,
                src_row=sr, src_col=sc))
            y_off += _ceil(cols) if mode == "aligned" else cols
        x_off += _ceil(h) if mode == "aligned" else h
    return PackedLayout(R=_ceil(max(x_off, 1)), C=_ceil(max(y_off, 1)),
                        placements={k: tuple(v)
                                    for k, v in placements.items()})


def pack_canvas(mats: Sequence[WeightMatrix], *, max_tile_rows: int = 4096,
                max_tile_cols: int = 4096) -> PackedLayout:
    """Lay matrices out on the virtual plane, minimizing the block cover.

    Mirrors the paper's §3.3 allocation scoring: candidate layouts
    (block-aligned vs tight-diagonal) are generated and the densest —
    fewest stored MXU blocks — wins. Groups are ordered tallest-first
    (the supertile/shelf heuristic) deterministically.

    Memoized per (mats, chunking) — WeightMatrix is frozen/hashable — so
    a serving process lays out each config once, not once per step.
    """
    return _pack_canvas_cached(tuple(mats), max_tile_rows, max_tile_cols)


@functools.lru_cache(maxsize=256)
def _pack_canvas_cached(mats: tuple[WeightMatrix, ...], max_tile_rows: int,
                        max_tile_cols: int) -> PackedLayout:
    names = [m.name for m in mats]
    if len(set(names)) != len(names):
        raise ValueError("duplicate matrix names")

    # expand into chunks grouped by input interval identity
    # group key: (share_group or name, src_row)
    groups: dict[tuple, list[tuple[WeightMatrix, tuple]]] = {}
    for m in mats:
        for ch in _chunk(m, max_tile_rows, max_tile_cols):
            h, w, sr, sc = ch
            key = (m.share_group or m.name, sr)
            groups.setdefault(key, []).append((m, ch))

    def g_height(entry):
        return max(ch[0] for _, ch in entry[1])

    ordered = sorted(groups.items(), key=lambda e: (-g_height(e), e[0]))

    candidates = [_lay_out(ordered, mode=m)
                  for m in ("aligned", "diagonal", "snapped")]
    return min(candidates, key=lambda l: l.num_blocks)
