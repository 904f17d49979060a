"""The paper's packing adapted to the card: the virtual-plane layout of
many weight matrices (a copy of the JAX package's ``planner.mxu_pack``)
and the weight-residency planner (a copy of ``planner.residency``)."""

from .mxu_pack import (ChunkPlacement, PackedLayout, WeightMatrix,
                       pack_canvas)
from .residency import (Decision, LayerSlice, ParamTensor, ResidencyPlan,
                        layer_schedule, plan_residency, weight_inventory)

__all__ = ["ChunkPlacement", "PackedLayout", "WeightMatrix", "pack_canvas",
           "Decision", "LayerSlice", "ParamTensor", "ResidencyPlan",
           "layer_schedule", "plan_residency", "weight_inventory"]
