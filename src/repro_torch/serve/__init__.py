"""Serving of the port: the three-stage engine API, the continuous-batching
engines (ring and paged layouts, self-speculative decoding), the threaded
orchestrator, fault injection and the numeric guard."""
from .engine import Request, ServeConfig, ServingEngine
from .engine_api import (Prefix, TransprecisionEngine, rollback_paged_cache,
                         rollback_ring_cache)
from .faults import (Fault, FaultInjector, FaultPlan, InjectedFault,
                     RetryPolicy)
from .guard import GuardConfig, NumericGuard, fallback_ladder
from .orchestrator import Orchestrator, OrchestratorConfig, StreamingRequest
from .paged import PageAllocator, SlotPages, pages_for
from .speculative import SpeculativeEngine
