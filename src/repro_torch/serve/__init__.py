"""Serving: batched engine (prefill + decode), continuous-batching request
scheduler and the runtime bandwidth-budget controller."""
from .controller import (BandwidthController, ControllerPlan,
                         ControllerRecord, static_plan)
from .engine import (GenerationResult, ServeEngine, ServeStats, bucket_len,
                     sample)
from .scheduler import Request, RequestResult, Scheduler, synthetic_workload
