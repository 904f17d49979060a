"""The paper's packing adapted to the card: the virtual-plane layout of
many weight matrices (a copy of the JAX package's ``planner.mxu_pack``)."""

from .mxu_pack import (ChunkPlacement, PackedLayout, WeightMatrix,
                       pack_canvas)

__all__ = ["ChunkPlacement", "PackedLayout", "WeightMatrix", "pack_canvas"]
