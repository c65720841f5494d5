"""Offloading: the byte-metered expert store and its device LRU, the
layer-ahead prefetcher, and the async expert-streaming engine (pinned
host images, staging rings on a copy stream, device containers) that
turns the byte meter into a data path (the port of ``repro/offload``
without its simulator and expert-parallel store)."""
from .cache import *  # noqa
from .hostmem import (HostExpertImage, Payload, build_fallback_stack,
                      build_fallback_stacks)
from .prefetch import LayerAheadPrefetcher, PrefetchStats
from .staging import (DeviceTransferBackend, ExpertStreamEngine,
                      FakeTransferBackend, StagingRing, StagingSlot)
from .store import (ExpertCache, ExpertStore, FetchStats, make_expert_stores,
                    meter_decode_trace, offload_report, replay_decode_trace,
                    snapshot_offload)
