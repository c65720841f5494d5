"""Serving: batched engine (prefill + decode), continuous-batching request
scheduler, speculative decoding and the runtime bandwidth-budget
controller."""
from .controller import (BandwidthController, ControllerPlan,
                         ControllerRecord, static_plan)
from .engine import (GenerationResult, ServeEngine, ServeStats, bucket_len,
                     router_trace, sample)
from .paging import PagePool, PoolStats, prefix_page_hashes
from .scheduler import Request, RequestResult, Scheduler, synthetic_workload
from .speculative import (DraftModelDrafter, NGramDrafter, accept_drafts,
                          make_drafter, mask_banned)
