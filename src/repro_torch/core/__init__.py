# The paper's primary contribution: the weight-packing mapping algorithm
# (§3) + the IMC EDP cost model (§4) it is evaluated with. A copy of the
# JAX package's pure-Python ``core``: these modules import only each other.
from .allocation import Allocation, allocate_columns
from .baselines import flattened_plan, stacked_plan
from .columns import Column, Placement, ShelfPacker, generate_columns
from .cost_model import CostReport, LayerCost, plan_cost
from .imc_arch import (IMCArchitecture, IMCMacro, MemoryCosts, a_imc,
                       a_imc_macro, d_imc, d_imc_macro)
from .loops import LayerSpec, Workload, best_subproduct, prime_factors
from .packer import PackingError, PackingPlan, pack
from .supertiles import SuperTile, TileInstance, generate_supertiles
from .tiles import Tile, fold_tile, generate_tile, generate_tile_pool
from .workloads import (autoencoder, ds_cnn, lm_workload, mlperf_tiny_suite,
                        mobilenet_v1_025, resnet8)

__all__ = [
    "Allocation", "allocate_columns", "flattened_plan", "stacked_plan",
    "Column", "Placement", "ShelfPacker", "generate_columns", "CostReport",
    "LayerCost", "plan_cost", "IMCArchitecture", "IMCMacro", "MemoryCosts",
    "a_imc", "a_imc_macro", "d_imc", "d_imc_macro", "LayerSpec", "Workload",
    "best_subproduct", "prime_factors", "PackingError", "PackingPlan", "pack",
    "SuperTile", "TileInstance", "generate_supertiles", "Tile", "fold_tile",
    "generate_tile", "generate_tile_pool", "autoencoder", "ds_cnn",
    "lm_workload", "mlperf_tiny_suite", "mobilenet_v1_025", "resnet8",
]
