"""Expert store + device cache for offloaded serving (paper §2.1, §4.3);
a copy of ``repro/offload/store.py`` over the port's
``CompressedExpertStack`` (host code: numpy and the stacks' metadata).

``ExpertStore`` keeps compressed experts in *host* memory (numpy) and
fetches them on demand; ``ExpertCache`` is the device-resident LRU that
Mixtral-Offloading/HOBBIT-style systems maintain.  Every fetch is metered
in bytes so benchmarks can report exact PCIe/host-link traffic for
fp16 / uniform-quant / BEAM-LRC policies.

Metering semantics (fidelity-critical for the paper's wire-byte claims):

- compensator factors *ride the device cache* with the expert they
  compensate: they are fetched once when a top-n expert first needs them,
  stay resident while the expert does, and are refetched only after the
  expert is evicted — not re-charged on every token; under the bandwidth
  controller's per-layer rank caps only the capped factor rows move, and
  a later cap *raise* fetches just the missing rows (the delta);
- prefetched experts are inserted into the LRU ahead of the access (so a
  correct prediction becomes a *hit*) and their traffic is metered as
  ``prefetch_bytes``; bytes fetched for predictions the step never used
  are additionally reported as ``wasted_prefetch_bytes``;
- expert ids < 0 mark inactive scheduler slots and are skipped entirely.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.pipeline import CompressedExpertStack
from ..core.quantize import factor_wire_bytes


@dataclasses.dataclass
class FetchStats:
    bytes_moved: int = 0
    fetches: int = 0
    hits: int = 0
    misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ExpertCache:
    """Per-layer LRU over expert ids with byte-metered misses.

    ``last_evicted`` holds the expert id dropped by the most recent
    ``access``/``insert`` (or None) — the store uses it to evict that
    expert's cache-resident compensator factors along with the weights.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lru: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self.stats = FetchStats()
        self.last_evicted: Optional[int] = None

    def __contains__(self, expert: int) -> bool:
        return expert in self._lru

    def _insert(self, expert: int, nbytes: int):
        self._lru[expert] = nbytes
        self.last_evicted = None
        if len(self._lru) > self.capacity:
            self.last_evicted, _ = self._lru.popitem(last=False)

    def access(self, expert: int, nbytes: int) -> bool:
        """True on hit; on miss, meters ``nbytes`` and inserts."""
        self.last_evicted = None
        if expert in self._lru:
            self._lru.move_to_end(expert)
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        self.stats.fetches += 1
        self.stats.bytes_moved += nbytes
        self._insert(expert, nbytes)
        return False

    def insert(self, expert: int, nbytes: int) -> bool:
        """Prefetch-path insert: warms the LRU without touching hit/miss
        stats (the demand access decides those) and without metering into
        ``stats.bytes_moved`` (the caller meters prefetch bytes).  Returns
        True if the expert was actually fetched (i.e. was not resident)."""
        self.last_evicted = None
        if expert in self._lru:
            self._lru.move_to_end(expert)
            return False
        self._insert(expert, nbytes)
        return True


class ExpertStore:
    """Host-side store of one MoE layer's compressed projections.

    ``fetch_policy``:
      'fp16'   — move full-precision experts (Mixtral-Offloading baseline)
      'quant'  — uniform low-bit, no compensators (HQQ/GPTQ baseline)
      'ours'   — low-bit + compensators for the top-n experts (BEAM-LRC)
    """

    def __init__(self, stacks: Dict[str, CompressedExpertStack],
                 cache_capacity: int = 4):
        self.stacks = stacks
        self.num_experts = next(iter(stacks.values())).scale.shape[0]
        self.cache = ExpertCache(cache_capacity)
        self.comp_bytes_moved = 0
        self.prefetch_bytes = 0
        self.wasted_prefetch_bytes = 0
        # async transfer engine (offload/staging.py).  When attached, the
        # meter drives real copies: every metering event calls back into
        # the engine, and the engine acknowledges each copy it puts on
        # the link via ``note_copy`` — the observed side of the
        # metered-bytes == observed-copies oracle.
        self._engine = None
        self.observed_copies = 0
        self.observed_copy_bytes = 0
        # expert -> rank cap its device-resident compensator factors were
        # fetched at (None = uncapped / full true rank); factors ride the
        # LRU with their expert (evicted together, refetched on the next
        # top-n access after eviction).  When the bandwidth controller
        # *raises* a layer's rank cap, the next access fetches only the
        # missing factor rows (the delta), not the whole factor again.
        self._comp_resident: Dict[int, Optional[int]] = {}

    def expert_bytes(self, e: int, policy: str) -> int:
        if policy == "fp16":
            return sum(s.fp16_wire_bytes for s in self.stacks.values())
        return sum(s.expert_wire_bytes(e, compensated=False)
                   for s in self.stacks.values())

    def compensator_bytes(self, e: int, rank_cap: Optional[int] = None
                          ) -> int:
        """Factor wire bytes for expert ``e`` at ``rank_cap`` (None = the
        true allocated rank; the cap slices the rank-padded factors)."""
        total = 0
        for s in self.stacks.values():
            r = s.ranks[e] if rank_cap is None else min(s.ranks[e],
                                                        int(rank_cap))
            total += factor_wire_bytes(r, s.shape[1], s.shape[2],
                                       s.factor_bits)
        return total

    def _drop_evicted(self):
        if self.cache.last_evicted is not None:
            self._comp_resident.pop(self.cache.last_evicted, None)

    # -- transfer-engine plumbing ------------------------------------------
    def attach_engine(self, hook):
        """Attach a transfer-engine hook (``on_demand`` / ``on_factors`` /
        ``on_prefetch``); pass None to detach."""
        self._engine = hook

    def note_copy(self, nbytes: int):
        """Transfer-engine acknowledgement that ``nbytes`` were put on the
        link for a metering event of this store (counted at copy issue)."""
        self.observed_copies += 1
        self.observed_copy_bytes += int(nbytes)

    def absorb_external_copy(self, e: int, nbytes: int,
                             comp_rank: Optional[int] = None,
                             comp_bytes: int = 0) -> int:
        """Meter a copy the engine performed that no demand/compensator
        event claimed (an optimistic stage the accepted trace never
        touched): insert the expert so residency matches the container,
        charge the traffic as prefetch, and acknowledge the copy.
        Returns the bytes metered (the caller attributes them to
        ``wasted_prefetch_bytes``)."""
        e = int(e)
        moved = 0
        if nbytes:
            if self.cache.insert(e, int(nbytes)):
                self._drop_evicted()
                moved += int(nbytes)
        if comp_bytes:
            have = self._comp_resident.get(e, -1)
            if have is not None:
                self._comp_resident[e] = comp_rank
                moved += int(comp_bytes)
        if moved:
            self.prefetch_bytes += moved
            self.note_copy(moved)
        return moved

    def access_token(self, topk: np.ndarray, top_n: int, policy: str,
                     rank_cap: Optional[int] = None) -> int:
        """Meter one token's expert fetches; returns bytes moved.

        Entries < 0 (masked / inactive scheduler slots) are skipped.
        ``rank_cap`` caps the compensator rank fetched for restored
        experts (the controller's per-layer plan; None = full rank)."""
        before = self.total_bytes
        for rank, e in enumerate(topk):
            e = int(e)
            if e < 0:
                continue
            hit = self.cache.access(e, self.expert_bytes(e, policy))
            self._drop_evicted()
            if not hit and self._engine is not None:
                self._engine.on_demand(self, e, self.expert_bytes(e, policy))
            if policy == "ours" and rank < top_n:
                # compensators ride the cache with their expert: fetch
                # only what is not already resident (a raised cap fetches
                # the missing rank rows only)
                have = self._comp_resident.get(e, -1)     # -1 = absent
                if have is None:
                    continue                              # full rank resident
                need = self.compensator_bytes(e, rank_cap)
                held = 0 if have < 0 else self.compensator_bytes(e, have)
                if need > held:
                    self.comp_bytes_moved += need - held
                    if self._engine is not None:
                        self._engine.on_factors(self, e, have, rank_cap,
                                                need - held)
                if have < 0 or rank_cap is None or rank_cap > have:
                    self._comp_resident[e] = rank_cap
        return self.total_bytes - before

    def prefetch(self, experts: Iterable[int], policy: str
                 ) -> Dict[int, int]:
        """Warm the LRU with predicted experts ahead of the demand access.

        Fetched bytes land in ``prefetch_bytes`` (they are real wire
        traffic); returns {expert: bytes} for the experts actually fetched
        so the caller can meter the wasted share after scoring."""
        fetched: Dict[int, int] = {}
        for e in experts:
            e = int(e)
            if e < 0:
                continue
            nb = self.expert_bytes(e, policy)
            if e in self.cache:
                self.cache.insert(e, nb)          # refresh LRU position
                continue
            if self._engine is not None and not self._engine.on_prefetch(
                    self, e, nb):
                # staging ring full: the copy cannot move, so the store
                # must neither meter it nor warm the LRU with it
                continue
            self.cache.insert(e, nb)
            self._drop_evicted()
            self.prefetch_bytes += nb
            fetched[e] = nb
        return fetched

    @property
    def total_bytes(self) -> int:
        return (self.cache.stats.bytes_moved + self.comp_bytes_moved
                + self.prefetch_bytes)

    @property
    def shard_totals(self) -> np.ndarray:
        """(1,) per-shard wire bytes — the single-shard degenerate form of
        ``ShardedExpertStore.shard_totals`` so reduction code is uniform."""
        return np.asarray([self.total_bytes], np.int64)


# ---------------------------------------------------------------------------
# expert-parallel sharded store
# ---------------------------------------------------------------------------

class ShardedExpertStore:
    """EP partition of one MoE layer's store: ``ep`` per-shard
    ``ExpertStore``s, shard ``s`` owning the contiguous expert slice
    ``[s * E/ep, (s+1) * E/ep)`` — the same partition ``shard_map`` gives
    the device-side expert weights (``distributed/moe_parallel.py``).

    Each shard meters only its *resident* experts' wire bytes over its
    own device LRU and host link; a token's top-k fans out across the
    owning shards with the global rank positions preserved, so the
    router-guided ``top_n`` compensation decision is identical to the
    single-store path.  Aggregate properties reduce the per-shard
    counters for reports and the bandwidth controller; ``shard_totals``
    exposes the unreduced per-link bytes for the controller's
    ``per_shard`` budget scope and ``ServeStats``.

    Byte conservation: residency state (device LRU + resident compensator
    rank caps) is per-expert within a shard, and every expert belongs to
    exactly one shard at any shard count — so as long as no shard evicts
    (per-shard ``cache_capacity`` >= its E/ep residents), total demand +
    compensator bytes for the same routing trace are EXACTLY equal across
    shard counts (pinned by tests).  Under eviction pressure, totals may
    legitimately differ: partitioning the LRU changes cache locality,
    on real hardware as here.
    """

    def __init__(self, stacks: Dict[str, CompressedExpertStack], ep: int,
                 cache_capacity: int = 4):
        num_experts = next(iter(stacks.values())).scale.shape[0]
        if ep < 1 or num_experts % ep:
            raise ValueError(f"{num_experts} experts do not partition over "
                             f"ep={ep} shards")
        self.stacks = stacks
        self.ep = ep
        self.num_experts = num_experts
        self.experts_per_shard = num_experts // ep
        self.shards = [ExpertStore(stacks, cache_capacity=cache_capacity)
                       for _ in range(ep)]
        self.wasted_prefetch_bytes = 0

    def _owner(self, e: int) -> int:
        return int(e) // self.experts_per_shard

    def expert_bytes(self, e: int, policy: str) -> int:
        return self.shards[0].expert_bytes(e, policy)

    def compensator_bytes(self, e: int, rank_cap: Optional[int] = None
                          ) -> int:
        return self.shards[0].compensator_bytes(e, rank_cap)

    def access_token(self, topk: np.ndarray, top_n: int, policy: str,
                     rank_cap: Optional[int] = None) -> int:
        """Meter one token's fetches across the owning shards.

        Foreign experts are masked to -1 *in place of their rank
        position* before each shard's access, so ``rank < top_n``
        compensates exactly the assignments the single-store path would.
        """
        topk = np.asarray(topk)
        total = 0
        for s, shard in enumerate(self.shards):
            lo = s * self.experts_per_shard
            local = np.where((topk >= lo)
                             & (topk < lo + self.experts_per_shard),
                             topk, -1)
            if (local >= 0).any():
                total += shard.access_token(local, top_n=top_n,
                                            policy=policy, rank_cap=rank_cap)
        return total

    def prefetch(self, experts: Iterable[int], policy: str
                 ) -> Dict[int, int]:
        """Route predicted experts to their owning shard's prefetcher."""
        fetched: Dict[int, int] = {}
        for e in experts:
            e = int(e)
            if e < 0:
                continue
            fetched.update(self.shards[self._owner(e)].prefetch([e], policy))
        return fetched

    # -- transfer-engine plumbing ------------------------------------------
    def attach_engine(self, hook):
        """Attach one transfer-engine hook to every shard.  Expert
        ownership is disjoint across shards, so the shared per-layer
        engine state (containers, ring, ledger) sees each expert's
        events from exactly one shard."""
        for s in self.shards:
            s.attach_engine(hook)

    def absorb_external_copy(self, e: int, nbytes: int,
                             comp_rank: Optional[int] = None,
                             comp_bytes: int = 0) -> int:
        return self.shards[self._owner(e)].absorb_external_copy(
            e, nbytes, comp_rank=comp_rank, comp_bytes=comp_bytes)

    @property
    def observed_copies(self) -> int:
        return sum(s.observed_copies for s in self.shards)

    @property
    def observed_copy_bytes(self) -> int:
        return sum(s.observed_copy_bytes for s in self.shards)

    # -- aggregate views (same API surface as ExpertStore) -----------------
    @property
    def comp_bytes_moved(self) -> int:
        return sum(s.comp_bytes_moved for s in self.shards)

    @property
    def prefetch_bytes(self) -> int:
        return sum(s.prefetch_bytes for s in self.shards)

    @property
    def total_bytes(self) -> int:
        return sum(s.total_bytes for s in self.shards)

    @property
    def shard_totals(self) -> np.ndarray:
        """(ep,) wire bytes that crossed each shard's link."""
        return np.asarray([s.total_bytes for s in self.shards], np.int64)

    @property
    def cache(self):
        """Aggregated cache-stats facade (``snapshot_offload`` reads
        ``store.cache.stats``); hit/miss/fetch counts sum exactly because
        every expert access lands on exactly one shard."""
        agg = FetchStats(
            bytes_moved=sum(s.cache.stats.bytes_moved for s in self.shards),
            fetches=sum(s.cache.stats.fetches for s in self.shards),
            hits=sum(s.cache.stats.hits for s in self.shards),
            misses=sum(s.cache.stats.misses for s in self.shards))
        return _CacheView(agg)


@dataclasses.dataclass
class _CacheView:
    stats: FetchStats


def make_expert_stores(stacks_by_layer: List[Dict], *, ep: int = 1,
                       cache_capacity: int = 4) -> List:
    """Per-layer stores for serving: plain ``ExpertStore``s at ``ep=1``
    (or when the expert count does not partition — the engine's GSPMD
    fallback path), ``ShardedExpertStore``s otherwise."""
    stores = []
    for stacks in stacks_by_layer:
        e = next(iter(stacks.values())).scale.shape[0]
        if ep > 1 and e % ep == 0:
            stores.append(ShardedExpertStore(stacks, ep,
                                             cache_capacity=cache_capacity))
        else:
            stores.append(ExpertStore(stacks, cache_capacity=cache_capacity))
    return stores


# ---------------------------------------------------------------------------
# trace replay + reporting
# ---------------------------------------------------------------------------

def snapshot_offload(stores: List[ExpertStore], prefetcher=None) -> Dict:
    """Cumulative store/prefetcher counters, for delta-based reports.

    ``per_shard`` is the element-wise sum of every store's
    ``shard_totals`` — the per-link wire bytes under expert-parallel
    sharding, a length-1 vector for plain single-shard stores."""
    return {
        "demand": sum(s.cache.stats.bytes_moved for s in stores),
        "comp": sum(s.comp_bytes_moved for s in stores),
        "prefetch": sum(s.prefetch_bytes for s in stores),
        "wasted": sum(s.wasted_prefetch_bytes for s in stores),
        "total": sum(s.total_bytes for s in stores),
        "hits": sum(s.cache.stats.hits for s in stores),
        "misses": sum(s.cache.stats.misses for s in stores),
        "per_shard": sum(np.asarray(s.shard_totals, np.int64)
                         for s in stores),
        # observed transfer-engine copies (0 until streaming is attached);
        # the oracle pins observed == total per store, so these columns
        # let reports cross-check metered traffic against real copies
        "observed": sum(s.observed_copy_bytes for s in stores),
        "copies": sum(s.observed_copies for s in stores),
        "pf_issued": prefetcher.stats.issued if prefetcher is not None else 0,
        "pf_useful": prefetcher.stats.useful if prefetcher is not None else 0,
    }


def offload_report(stores: List[ExpertStore], prefetcher, snap: Dict,
                   tokens: int, policy: str) -> Dict:
    """Report dict covering the traffic since ``snap`` (snapshot_offload)."""
    now = snapshot_offload(stores, prefetcher)
    d = {k: now[k] - snap[k] for k in now}
    issued = d["pf_issued"]
    per_shard = np.asarray(d["per_shard"], np.int64).reshape(-1)
    return {
        "policy": policy,
        "tokens": tokens,
        "total_bytes": int(d["total"]),
        "bytes_per_token": d["total"] / max(tokens, 1),
        "demand_bytes": int(d["demand"]),
        "compensator_bytes": int(d["comp"]),
        "prefetch_bytes": int(d["prefetch"]),
        "wasted_prefetch_bytes": int(d["wasted"]),
        "hit_rate": d["hits"] / max(d["hits"] + d["misses"], 1),
        "prefetch_accuracy": (d["pf_useful"] / max(issued, 1)
                              if prefetcher is not None else None),
        # expert-parallel reduction: per-link traffic + the hottest link
        # (what the controller's per_shard budget scope targets)
        "ep": int(per_shard.shape[0]),
        "per_shard_bytes": [int(b) for b in per_shard],
        "max_shard_bytes_per_token": (int(per_shard.max())
                                      / max(tokens, 1)),
        "observed_copy_bytes": int(d["observed"]),
        "observed_copies": int(d["copies"]),
    }


def _per_layer(val, layers: int, default):
    """Broadcast a scalar / per-layer sequence plan knob to (layers,)."""
    if val is None:
        return [default] * layers
    arr = np.asarray(val)
    if arr.ndim == 0:
        return [arr.item()] * layers
    if arr.shape[0] != layers:
        raise ValueError(f"per-layer plan has {arr.shape[0]} entries for "
                         f"{layers} MoE layers")
    return [a.item() for a in arr]


def replay_decode_trace(stores: List[ExpertStore], trace: np.ndarray, *,
                        policy: str = "ours", top_n=1,
                        rank_caps=None,
                        prefetcher=None) -> Tuple[int, np.ndarray]:
    """Replay a (steps, moe_layers, B, k) decode trace into the stores.

    Batch rows whose expert ids are < 0 are *inactive scheduler slots*:
    they are skipped by the prefetcher and the stores.  ``top_n`` and
    ``rank_caps`` may be scalars or per-layer (moe_layers,) sequences —
    the bandwidth controller's plan; ``rank_caps=None`` meters full-rank
    compensators (the static pre-controller behaviour).  Returns
    ``(tokens, slot_bytes)`` — the number of active (step, slot) tokens
    metered and the demand+compensator bytes attributed per batch slot
    (prefetch traffic is shared and not slot-attributable).
    """
    trace = np.asarray(trace)
    steps, layers, b, _ = trace.shape
    if layers != len(stores):
        raise ValueError(f"trace has {layers} MoE layers but "
                         f"{len(stores)} stores attached")
    top_ns = _per_layer(top_n, layers, 1)
    caps = _per_layer(rank_caps, layers, None)
    slot_bytes = np.zeros((b,), np.int64)
    tokens = 0
    for t in range(steps):
        active = trace[t, 0, :, 0] >= 0               # (B,) slot mask
        if not active.any():
            continue
        tokens += int(active.sum())
        for l in range(layers):
            experts = trace[t, l]                     # (B, k)
            live = experts[active]
            if prefetcher is not None:
                # while layer l-1 computes, fetch the predicted experts of
                # layer l so correct predictions turn into cache hits
                pred = prefetcher.predict(l)
                fetched = (stores[l].prefetch(pred, policy)
                           if pred is not None else {})
                prefetcher.observe(l, live)
                if fetched:
                    used = set(int(e) for e in live.reshape(-1))
                    stores[l].wasted_prefetch_bytes += sum(
                        nb for e, nb in fetched.items() if e not in used)
            for bi in np.nonzero(active)[0]:
                slot_bytes[bi] += stores[l].access_token(
                    experts[bi], top_n=top_ns[l], policy=policy,
                    rank_cap=caps[l])
    return tokens, slot_bytes


def replay_spec_round(stores: List[ExpertStore], trace: np.ndarray,
                      accepted: np.ndarray, *,
                      policy: str = "ours", top_n=1, rank_caps=None,
                      lookahead=None) -> Tuple[int, np.ndarray, int]:
    """Replay one speculative verify round into the stores.

    ``trace``: (round_steps, moe_layers, B, k), the verify pass's FULL
    router trace, covering accepted *and* rejected positions of live
    slots (inactive scheduler slots masked to -1).  ``accepted``:
    (round_steps, B) bool, the scheduler-accepted positions; only those
    are demand-metered, matching the non-speculative convention that
    masked compute never reaches the wire-byte meter.  The ``lookahead``
    prefetcher (``LookaheadPrefetcher``) warms the stores for EVERY live
    position: warms for positions that end up rejected are the
    attributable cost of speculation, charged to the stores'
    wasted-prefetch meter and returned as draft overhead bytes.

    Every byte still moves through ``ExpertStore.prefetch`` /
    ``access_token``, so under streaming the transfer engine observes a
    real copy for every metered byte (``total_bytes ==
    observed_copy_bytes``) with speculation on.

    Returns ``(tokens, slot_bytes, draft_overhead_bytes)``.
    """
    trace = np.asarray(trace)
    accepted = np.asarray(accepted, bool)
    steps, layers, b, _ = trace.shape
    if layers != len(stores):
        raise ValueError(f"trace has {layers} MoE layers but "
                         f"{len(stores)} stores attached")
    if accepted.shape != (steps, b):
        raise ValueError(f"accepted mask {accepted.shape} != {(steps, b)}")
    top_ns = _per_layer(top_n, layers, 1)
    caps = _per_layer(rank_caps, layers, None)
    if lookahead is not None:
        lookahead.begin_round(trace)
    slot_bytes = np.zeros((b,), np.int64)
    tokens = 0
    overhead = 0
    for t in range(steps):
        live = trace[t, 0, :, 0] >= 0                 # (B,) slot mask
        acc = accepted[t] & live
        tokens += int(acc.sum())
        if not live.any():
            continue
        for l in range(layers):
            experts = trace[t, l]                     # (B, k)
            if lookahead is not None:
                pred = lookahead.predict(t, l)
                fetched = (stores[l].prefetch(pred, policy)
                           if pred is not None else {})
                if pred is not None:
                    wb = lookahead.score(pred, experts[acc], fetched)
                    stores[l].wasted_prefetch_bytes += wb
                    overhead += wb
            for bi in np.nonzero(acc)[0]:
                slot_bytes[bi] += stores[l].access_token(
                    experts[bi], top_n=top_ns[l], policy=policy,
                    rank_cap=caps[l])
    return tokens, slot_bytes, overhead


def meter_decode_trace(stores: List[ExpertStore], trace: np.ndarray, *,
                       policy: str = "ours", top_n=1,
                       rank_caps=None, prefetcher=None) -> Dict:
    """Replay a live decode trace through per-layer stores.

    ``trace``: (steps, moe_layers, B, k) routed expert ids, exactly the
    ``GenerationResult.router_trace`` the serve engine's jitted decode
    loop emits — so the wire bytes / hit rates below are measured from
    real serving decisions, not the synthetic simulator.  Batch rows with
    expert id -1 are inactive scheduler slots and are skipped.

    The stores keep their cumulative lifetime stats (and cache state warm
    across calls); the returned report covers THIS replay only, so
    repeated ``generate`` calls don't double-count earlier traffic.

    Returns a report dict: bytes/token (demand + compensator + prefetch),
    per-category bytes, cache hit rate, prefetch accuracy.
    """
    snap = snapshot_offload(stores, prefetcher)
    tokens, _ = replay_decode_trace(stores, trace, policy=policy,
                                    top_n=top_n, rank_caps=rank_caps,
                                    prefetcher=prefetcher)
    return offload_report(stores, prefetcher, snap, tokens, policy)
