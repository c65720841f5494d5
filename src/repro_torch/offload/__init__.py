"""Offloading: the byte-metered expert store and its device LRU, and the
layer-ahead prefetcher (host code; the port of the metering half of
``repro/offload``)."""
from .cache import *  # noqa
from .prefetch import LayerAheadPrefetcher, PrefetchStats
from .store import (ExpertCache, ExpertStore, FetchStats, make_expert_stores,
                    meter_decode_trace, offload_report, replay_decode_trace,
                    snapshot_offload)
