"""Runtime of the port: page allocator, scheduler, prefix index,
device loop state, the fused horizon's CUDA graphs, the
continuous-batching engine (dense/vlm, MLA-MoE, recurrent and hybrid
backends), the static lockstep path (every ported family), the
multi-tenant model pool (residency packing, the DMA channel, the device
arena, ``PooledEngine``), the replicated fleet with its fault layer, and
the training supervisor over the checkpoint manager."""

from .arena import ArenaConfig, DeviceArena, partition_pages
from .decode_graph import DecodeGraph
from .device_state import DeviceLoopState
from .dma import DeviceDmaChannel, DmaChannel, WeightStream
from .engine import (ENGINE_FAMILIES, Engine, EngineConfig, EngineReport,
                     HybridBackend, LatentBackend, PagedTransformerBackend,
                     PoolEngineConfig, PooledEngine, PooledReport,
                     RecurrentBackend, encdec_extras_fn, engine_backend,
                     make_batch_sampler, resolve_backend, run_static,
                     vlm_extras_fn)
from .fault_tolerance import (TRANSIENT_DEFAULT, Backoff, ElasticConfig,
                              FaultEvent, FaultSchedule, RunReport,
                              StepTimeout, StragglerDetector, TransientFault,
                              TrainingSupervisor)
from .fleet import (FleetConfig, FleetEngine, FleetReport, ModelDesc,
                    place_models, zoo_descs)
from .kv_pager import NEUTRAL_OWNER, TRASH_PAGE, PageAllocator, PagerConfig
from .model_pool import (HBM_BYTES_PER_S, HOST_LINK_BYTES_PER_S, ModelEntry,
                         ModelPool, PoolConfig, PoolError, PoolPlan,
                         calibrated_reload_bytes_per_step,
                         decode_step_bound_s, model_weight_bytes)
from .prefix_index import PrefixIndex
from .scheduler import (MultiQueueScheduler, Request, Scheduler,
                        diurnal_trace, multi_tenant_trace, poisson_trace,
                        shared_prefix_trace, shifting_mix_trace)

__all__ = ["ENGINE_FAMILIES", "HBM_BYTES_PER_S", "HOST_LINK_BYTES_PER_S",
           "NEUTRAL_OWNER", "TRANSIENT_DEFAULT", "TRASH_PAGE",
           "ArenaConfig", "Backoff", "DecodeGraph", "DeviceArena",
           "DeviceDmaChannel", "DeviceLoopState", "DmaChannel",
           "ElasticConfig", "Engine", "EngineConfig", "EngineReport",
           "FaultEvent", "FaultSchedule",
           "FleetConfig", "FleetEngine", "FleetReport", "HybridBackend",
           "LatentBackend", "ModelDesc", "ModelEntry", "ModelPool",
           "MultiQueueScheduler", "PageAllocator", "PagedTransformerBackend",
           "PagerConfig", "PoolConfig", "PoolEngineConfig", "PoolError",
           "PoolPlan", "PooledEngine", "PooledReport", "PrefixIndex",
           "RecurrentBackend", "Request", "RunReport", "Scheduler",
           "StepTimeout", "StragglerDetector", "TrainingSupervisor",
           "TransientFault", "WeightStream",
           "calibrated_reload_bytes_per_step", "decode_step_bound_s",
           "diurnal_trace", "encdec_extras_fn", "engine_backend",
           "make_batch_sampler", "model_weight_bytes", "multi_tenant_trace",
           "partition_pages", "place_models", "poisson_trace",
           "resolve_backend", "run_static", "shared_prefix_trace",
           "shifting_mix_trace", "vlm_extras_fn", "zoo_descs"]
