"""Serving runtime of the port: page allocator, scheduler, prefix index,
device loop state and the continuous-batching engine."""

from .device_state import DeviceLoopState
from .engine import (Engine, EngineConfig, EngineReport,
                     PagedTransformerBackend, make_batch_sampler, run_static)
from .kv_pager import NEUTRAL_OWNER, TRASH_PAGE, PageAllocator, PagerConfig
from .prefix_index import PrefixIndex
from .scheduler import (MultiQueueScheduler, Request, Scheduler,
                        poisson_trace, shared_prefix_trace)

__all__ = ["NEUTRAL_OWNER", "TRASH_PAGE", "DeviceLoopState", "Engine",
           "EngineConfig", "EngineReport", "MultiQueueScheduler",
           "PageAllocator", "PagedTransformerBackend", "PagerConfig",
           "PrefixIndex", "Request", "Scheduler", "make_batch_sampler",
           "poisson_trace", "run_static", "shared_prefix_trace"]
