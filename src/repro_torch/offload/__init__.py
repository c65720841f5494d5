"""Offloading: the byte-metered expert store and its device LRU, the
layer-ahead and the speculative lookahead prefetchers, and the async
expert-streaming engine (pinned host images, staging rings on a copy
stream, device containers) that turns the byte meter into a data path,
and the event-driven offload simulator over the paper's hardware
profiles (the port of ``repro/offload`` without its expert-parallel
store)."""
from .bandwidth import GPU_NDP, GPU_ONLY, PROFILES, HardwareProfile
from .cache import *  # noqa
from .hostmem import (HostExpertImage, Payload, build_fallback_stack,
                      build_fallback_stacks)
from .prefetch import (LayerAheadPrefetcher, LookaheadPrefetcher,
                       PrefetchStats)
from .staging import (DeviceTransferBackend, ExpertStreamEngine,
                      FakeTransferBackend, StagingRing, StagingSlot)
from .store import (ExpertCache, ExpertStore, FetchStats, make_expert_stores,
                    meter_decode_trace, offload_report, replay_decode_trace,
                    replay_spec_round, snapshot_offload)
from .simulator import (LayerSpecSim, SimResult, expert_flops,
                        make_router_trace, simulate_decode)
