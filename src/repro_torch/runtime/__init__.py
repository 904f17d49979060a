"""Serving runtime of the port: page allocator, scheduler, prefix index,
device loop state, the fused horizon's CUDA graphs, the
continuous-batching engine (dense/vlm, MLA-MoE, recurrent and hybrid
backends) and the static lockstep path (every ported family)."""

from .decode_graph import DecodeGraph
from .device_state import DeviceLoopState
from .engine import (ENGINE_FAMILIES, Engine, EngineConfig, EngineReport,
                     HybridBackend, LatentBackend, PagedTransformerBackend,
                     RecurrentBackend, encdec_extras_fn, engine_backend,
                     make_batch_sampler, resolve_backend, run_static,
                     vlm_extras_fn)
from .kv_pager import NEUTRAL_OWNER, TRASH_PAGE, PageAllocator, PagerConfig
from .prefix_index import PrefixIndex
from .scheduler import (MultiQueueScheduler, Request, Scheduler,
                        poisson_trace, shared_prefix_trace)

__all__ = ["ENGINE_FAMILIES", "NEUTRAL_OWNER", "TRASH_PAGE",
           "DecodeGraph", "DeviceLoopState", "Engine", "EngineConfig", "EngineReport",
           "HybridBackend", "LatentBackend", "MultiQueueScheduler", "PageAllocator",
           "PagedTransformerBackend", "PagerConfig", "PrefixIndex",
           "RecurrentBackend", "Request", "Scheduler", "encdec_extras_fn",
           "engine_backend", "make_batch_sampler", "poisson_trace",
           "resolve_backend", "run_static", "shared_prefix_trace",
           "vlm_extras_fn"]
