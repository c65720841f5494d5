"""Async expert-streaming transfer engine: staging rings + device
containers (port of ``repro/offload/staging.py``).

This module turns the offload byte meter (``offload/store.py``) from
accounting into a data path.  Components:

- :class:`DeviceTransferBackend` / :class:`FakeTransferBackend` — the
  H2D copy primitive.  On a CUDA engine a copy is one
  ``cudaMemcpyAsync`` from the pinned host image into a device staging
  buffer on a dedicated copy stream, followed by a recorded
  ``torch.cuda.Event``; readiness is ``event.query()``.  On a CPU engine
  a copy is a plain host copy, ready at once.  The fake backend wraps
  the real copies with an injected per-copy delay and a stall predicate
  (fault-injection tests).
- :class:`StagingRing` — the per-layer slot ring.  A slot walks FREE ->
  IN_FLIGHT -> READY -> FREE; a slot is never reused while its copy is
  in flight, and when every slot is busy further issues are *declined*
  (the store then must not meter the prefetch — ring capacity is a
  metering-visible constraint).  Each slot owns its device staging
  buffer.
- :class:`ExpertStreamEngine` — per-MoE-layer coordination: a
  :class:`~.hostmem.HostExpertImage` copy source, a staging ring, and
  the device *containers* (fallback-initialized
  ``CompressedExpertStack``s inside the serving params) that streamed
  payloads are copied into between decode chunks.

Oracle invariant (metered bytes == observed copies): every copy is
driven by, or reconciled with, a store metering event —

- ``store.prefetch``  -> ``on_prefetch``: the engine issues the async
  ring copy FIRST and the store meters only if the issue was accepted;
- demand miss         -> ``on_demand``: a copy staged earlier by the
  optimistic-execution fixpoint is *consumed* from the engine's ledger,
  otherwise a fresh copy is performed on the spot;
- compensator fetch   -> ``on_factors``: same ledger/fresh split for
  factor rank rows;
- staged copies the accepted trace never touched are *flushed* into the
  store as (wasted) prefetch bytes at the chunk boundary
  (``flush_unclaimed`` -> ``store.absorb_external_copy``).

Observed bytes are counted at copy *issue* time via ``store.note_copy``
in the store's wire formula (the JAX engine's counters), so the equality
holds exactly per store.  Under eviction the LRU is the accounting model
while the container is the physical state: a charged re-fetch of data
still physically present is performed as a real re-copy.

Where the JAX engine swaps each updated stack into the stacks dict
(functional updates), the port's decode graph reads the containers by
pointer, so they are updated IN PLACE: a payload is copied into slices
of the container tensors (``[e]`` for planes, scale and zero, the rank
window for factors) on the current stream, never swapped.  A ring copy
never writes a container directly: it lands in its slot's staging
buffer, and ``integrate_ready`` makes the current stream wait on the
copy's event and copies slot -> container between chunks; the slot's
buffer is reused only after that copy (an event recorded after it, which
the copy stream waits on).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .hostmem import HostExpertImage, Payload, build_fallback_stacks
from .store import _per_layer

FREE, IN_FLIGHT, READY = "free", "in_flight", "ready"

# slot kinds
KIND_WEIGHTS, KIND_FACTORS = "w", "f"


# ---------------------------------------------------------------------------
# transfer backends
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Staging:
    """One copy lane (a ring slot, or the demand path): the device bytes
    an H2D copy lands in and the lane's two events (recorded anew by
    every copy), which guard their reuse.  A lane holds one copy at a
    time."""
    dev: Optional[torch.Tensor] = None     # (n,) uint8 on the device
    h2d: Optional[Any] = None              # after the lane's last H2D copy
    free: Optional[Any] = None             # after the last read of ``dev``


@dataclasses.dataclass
class _Handle:
    dev: torch.Tensor                      # the landed bytes
    payload: Payload
    event: Any                             # None on a CPU backend
    staging: Optional[Staging]


class DeviceTransferBackend:
    """H2D copies for one engine device.

    ``copy`` returns an opaque handle; ``is_ready`` observes completion
    without blocking; ``payload`` yields the landed payload (its bytes
    on the device) for integration, the current stream made to wait for
    the copy first; ``release`` marks the integration's reads of the
    staging buffer enqueued, after which the buffer may be written
    again.

    On a CUDA device every copy runs on the backend's own stream from
    pinned host memory: a pageable source raises (it would be a silent
    synchronous copy).  ``ordered``: a copy of this backend always
    completes, so the engine may order its consumers behind the copy's
    event on the device instead of waiting for it on the host (a CUDA
    backend; the fake backend gates readiness, so it is waited for)."""

    poll_s = 0.0               # host wait between readiness polls

    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.ordered = self.cuda

    def reserve(self, staging: Staging, nbytes: int) -> None:
        """Give ``staging`` a device buffer of at least ``nbytes`` (a
        CUDA backend; the engine reserves every lane's largest payload
        up front, so a copy never reallocates)."""
        if not self.cuda or (staging.dev is not None
                             and staging.dev.numel() >= nbytes):
            return
        if staging.dev is not None:
            # the old buffer may still be read or written
            torch.cuda.synchronize(self.device)
        staging.dev = torch.empty((nbytes,), dtype=torch.uint8,
                                  device=self.device)

    def copy(self, payload: Payload, tag=None,
             staging: Optional[Staging] = None) -> _Handle:
        n = payload.nbytes
        if not self.cuda:
            return _Handle(payload.data.clone(), payload, None, staging)
        if not payload.data.is_pinned():
            raise RuntimeError("an H2D stream copy needs a pinned host "
                               "source")
        if staging is None:
            staging = Staging()
        self.reserve(staging, n)
        if staging.h2d is None:
            staging.h2d = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            if staging.free is not None:
                self.stream.wait_event(staging.free)
            dst = staging.dev[:n]
            dst.copy_(payload.data, non_blocking=True)
            staging.h2d.record(self.stream)
        return _Handle(dst, payload, staging.h2d, staging)

    def is_ready(self, handle: _Handle) -> bool:
        return handle.event is None or handle.event.query()

    def payload(self, handle: _Handle) -> Payload:
        if handle.event is not None:
            torch.cuda.current_stream(self.device).wait_event(handle.event)
        return Payload(handle.dev, handle.payload.leaves)

    def release(self, handle: _Handle) -> None:
        st = handle.staging
        if handle.event is not None and st is not None:
            if st.free is None:
                st.free = torch.cuda.Event()
            st.free.record(torch.cuda.current_stream(self.device))


@dataclasses.dataclass
class _FakeHandle:
    dev: Any
    tag: Any
    t0: float


class FakeTransferBackend(DeviceTransferBackend):
    """Delay/stall-injecting backend for fault tests.

    Copies still land on the device (integration works normally), but
    readiness is gated: each copy reports ready only ``delay_s`` after
    issue, and copies whose ``stall`` predicate matches never report
    ready at all (a wedged DMA channel).  ``stall`` may be a callable
    over the copy tag ``(layer, expert, kind)`` or a collection of
    expert ids.  ``clock`` is injectable for deterministic tests."""

    poll_s = 5e-4

    def __init__(self, delay_s: float = 0.0, stall=None,
                 clock: Callable[[], float] = time.monotonic, device=None):
        super().__init__(device)
        self.ordered = False
        self.delay_s = float(delay_s)
        self.clock = clock
        if stall is None:
            self._stall = lambda tag: False
        elif callable(stall):
            self._stall = stall
        else:
            stalled = set(stall)
            self._stall = lambda tag: tag is not None and tag[1] in stalled
        self.copies = 0

    def copy(self, payload, tag=None, staging=None):
        self.copies += 1
        return _FakeHandle(super().copy(payload, tag, staging), tag,
                           self.clock())

    def is_ready(self, handle) -> bool:
        if self._stall(handle.tag):
            return False
        if (self.clock() - handle.t0) < self.delay_s:
            return False
        return super().is_ready(handle.dev)

    def payload(self, handle):
        return super().payload(handle.dev)

    def release(self, handle) -> None:
        super().release(handle.dev)


# ---------------------------------------------------------------------------
# staging ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StagingSlot:
    index: int
    state: str = FREE
    expert: int = -1
    kind: str = ""
    wire_bytes: int = 0
    meta: Any = None
    handle: Any = None
    t_issue: float = 0.0
    generation: int = 0      # bumped per issue (slot-reuse auditing)
    # the slot's own copy lane (its device staging buffer and events)
    staging: Staging = dataclasses.field(default_factory=Staging)


class StagingRing:
    """Fixed-capacity slot ring for one layer's in-flight copies.

    State machine per slot: FREE --issue--> IN_FLIGHT --poll/ready-->
    READY --release--> FREE, with ``abandon`` the IN_FLIGHT -> FREE
    escape hatch for stalled copies.  ``try_issue`` returns None when no
    slot is FREE — the caller must treat that as "the copy cannot move",
    never queue past capacity."""

    def __init__(self, capacity: int, backend: DeviceTransferBackend,
                 clock: Callable[[], float] = time.perf_counter,
                 tag: Any = None):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.backend = backend
        self.clock = clock
        self.tag = tag
        self.slots = [StagingSlot(i) for i in range(capacity)]

    @property
    def capacity(self) -> int:
        return len(self.slots)

    @property
    def occupancy(self) -> int:
        return sum(1 for s in self.slots if s.state != FREE)

    def in_flight(self) -> List[StagingSlot]:
        return [s for s in self.slots if s.state == IN_FLIGHT]

    def find(self, expert: int, kind: str) -> Optional[StagingSlot]:
        for s in self.slots:
            if s.state != FREE and s.expert == expert and s.kind == kind:
                return s
        return None

    def try_issue(self, expert: int, payload, wire_bytes: int,
                  kind: str = KIND_WEIGHTS, meta=None
                  ) -> Optional[StagingSlot]:
        slot = next((s for s in self.slots if s.state == FREE), None)
        if slot is None:
            return None
        slot.handle = self.backend.copy(payload,
                                        tag=(self.tag, int(expert), kind),
                                        staging=slot.staging)
        slot.state = IN_FLIGHT
        slot.expert = int(expert)
        slot.kind = kind
        slot.wire_bytes = int(wire_bytes)
        slot.meta = meta
        slot.t_issue = self.clock()
        slot.generation += 1
        return slot

    def poll(self):
        for s in self.slots:
            if (s.state == IN_FLIGHT and s.handle is not None
                    and self.backend.is_ready(s.handle)):
                s.state = READY

    def take_ready(self) -> List[StagingSlot]:
        self.poll()
        return [s for s in self.slots if s.state == READY]

    def wait(self, slot: StagingSlot, timeout_s: float) -> bool:
        """Block until ``slot``'s copy is READY; False on timeout (the
        stalled-copy degrade path)."""
        deadline = self.clock() + timeout_s
        while True:
            self.poll()
            if slot.state == READY:
                return True
            if slot.state == FREE:        # abandoned under us
                return False
            if self.clock() >= deadline:
                return False
            time.sleep(self.backend.poll_s)

    def _reset(self, slot: StagingSlot):
        slot.state = FREE
        slot.expert = -1
        slot.kind = ""
        slot.wire_bytes = 0
        slot.meta = None
        slot.handle = None
        slot.t_issue = 0.0

    def release(self, slot: StagingSlot):
        assert slot.state == READY, (slot.index, slot.state)
        self._reset(slot)

    def abandon(self, slot: StagingSlot):
        """Drop a stalled IN_FLIGHT copy (handle discarded; the slot is
        immediately reusable: a later copy into its buffers is ordered
        after this one on the copy stream)."""
        assert slot.state == IN_FLIGHT, (slot.index, slot.state)
        self._reset(slot)


# ---------------------------------------------------------------------------
# per-layer stream state
# ---------------------------------------------------------------------------

_NO_FACTORS = object()     # sentinel: no factor requirement in a need


class _LayerStream:
    def __init__(self, idx: int, image: HostExpertImage,
                 ring: StagingRing, containers: Dict, store):
        self.idx = idx
        self.image = image
        self.ring = ring
        # THE stacks dict inside the serving params: its stacks' tensors
        # are written in place, so the params (and every captured graph
        # over them) stay current
        self.containers = containers
        self.store = store
        self.valid: set = set()        # experts with true weights staged
        # expert -> rank cap its staged factor rows cover (None = full);
        # tracks CONTAINER content — unlike the store's ``_comp_resident``
        # it survives LRU eviction (the bytes stay physically on device)
        self.staged_cap: Dict[int, Optional[int]] = {}
        # unclaimed staged copies awaiting a store metering event:
        # ("w", e) -> wire bytes; ("f", e) -> (wire bytes, cap)
        self.ledger: Dict[Tuple[str, int], Any] = {}
        # expert -> its container weight slices as flat byte views, in
        # the payload's leaf order (one multi-tensor copy fills them)
        self._wdst: Dict[int, List[torch.Tensor]] = {}

    def weight_dst(self, e: int) -> List[torch.Tensor]:
        dst = self._wdst.get(e)
        if dst is None:
            dst = []
            for lf in self.image.weight_payload(e).leaves:
                st = self.containers[lf.proj]
                t = (st.planes[lf.plane] if lf.name == "planes"
                     else getattr(st, lf.name))[e]
                dst.append(t.view(torch.uint8).view(-1))
            self._wdst[e] = dst
        return dst

    # -- factor rank windows ----------------------------------------------
    def _resolve(self, e: int, cap, name: str) -> int:
        r = self.image.meta[name].ranks[e]
        return r if cap is None else min(r, int(cap))

    def factor_windows(self, e: int, have, cap) -> Dict[str, Tuple[int, int]]:
        """{proj: (lo, hi)} delta rank rows from ``have`` to ``cap``
        (store ``_comp_resident`` conventions: -1 absent, None full)."""
        out = {}
        for name in self.image.meta:
            lo = 0 if (have is not None and have < 0) \
                else self._resolve(e, have, name)
            hi = self._resolve(e, cap, name)
            if hi > lo:
                out[name] = (lo, hi)
        return out

    def factor_deficit(self, e: int, cap) -> Dict[str, Tuple[int, int]]:
        """Rank rows the CONTAINER is missing for expert ``e`` at ``cap``."""
        return self.factor_windows(e, self.staged_cap.get(e, -1), cap)

    def raise_staged_cap(self, e: int, cap):
        have = self.staged_cap.get(e, -1)
        if have is None:
            return
        if cap is None or (have is not None and have < 0) or cap > have:
            self.staged_cap[e] = cap


class _StoreHook:
    """Store-facing view of the engine for one MoE layer (attached to the
    layer's ``ExpertStore``)."""

    __slots__ = ("eng", "layer")

    def __init__(self, eng: "ExpertStreamEngine", layer: int):
        self.eng = eng
        self.layer = layer

    def on_demand(self, store, e: int, nbytes: int):
        self.eng._on_demand(self.layer, store, e, nbytes)

    def on_factors(self, store, e: int, have, cap, nbytes: int):
        self.eng._on_factors(self.layer, store, e, have, cap, nbytes)

    def on_prefetch(self, store, e: int, nbytes: int) -> bool:
        return self.eng._on_prefetch(self.layer, store, e, nbytes)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ExpertStreamEngine:
    """Coordinates host images, staging rings, and device containers for
    every MoE layer of a serving engine.  See the module docstring for
    the dataflow and the oracle invariant.

    The backend defaults to a ``DeviceTransferBackend`` on the stacks'
    device; the host images are pinned on a CUDA device."""

    def __init__(self, stores: List, stream_cfg, policy: str = "ours",
                 backend: Optional[DeviceTransferBackend] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if policy not in ("ours", "quant"):
            raise ValueError(f"streaming supports policies 'ours'/'quant', "
                             f"got {policy!r}")
        self.cfg = stream_cfg
        self.policy = policy
        dev = next(iter(stores[0].stacks.values())).scale.device
        self.backend = backend or DeviceTransferBackend(dev)
        if self.backend.device.type != dev.type:
            raise ValueError(f"transfer backend on {self.backend.device}, "
                             f"stacks on {dev}")
        self.clock = clock
        self.layers: List[_LayerStream] = []
        # the demand path's copy lane (demand copies are waited for one
        # at a time, so one lane serves every layer)
        self._demand = Staging()
        # setup seconds: the host images (pinning and filling them) and
        # the fallback containers
        self.image_s = self.fallback_s = 0.0
        for l, store in enumerate(stores):
            t0 = time.perf_counter()
            image = HostExpertImage(store.stacks, pin=self.backend.cuda)
            t1 = time.perf_counter()
            containers = build_fallback_stacks(store.stacks,
                                               stream_cfg.fallback_bits)
            if self.backend.cuda:
                torch.cuda.synchronize(dev)
            self.image_s += t1 - t0
            self.fallback_s += time.perf_counter() - t1
            ring = StagingRing(stream_cfg.ring_slots, self.backend,
                               clock=clock, tag=l)
            self.layers.append(_LayerStream(l, image, ring, containers,
                                            store))
            store.attach_engine(_StoreHook(self, l))
        lane = max(max(L.image.weight_bytes, L.image.max_factor_bytes)
                   for L in self.layers)
        for st in [self._demand] + [s.staging for L in self.layers
                                    for s in L.ring.slots]:
            self.backend.reserve(st, lane)
        if self.backend.cuda:
            torch.cuda.synchronize(dev)
        # counters (engine-level; per-store attribution lives in the
        # stores' observed_copies/observed_copy_bytes)
        self.issued_copies = 0
        self.issued_bytes = 0
        self.stalls = 0
        self.stall_s = 0.0
        self.transfer_s = 0.0          # async copy issue->observed-ready
        self.sync_copy_s = 0.0         # replay-time reconciliation copies
        self.reruns = 0
        self.degraded_tokens = 0
        self.abandoned_copies = 0
        self.flushed_bytes = 0

    # -- container access ---------------------------------------------------
    def layer_containers(self, l: int) -> Dict:
        return self.layers[l].containers

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    # -- copy plumbing ------------------------------------------------------
    def _count_issue(self, nbytes: int):
        self.issued_copies += 1
        self.issued_bytes += int(nbytes)

    def _wait_handle(self, handle, timeout_s: float) -> bool:
        deadline = self.clock() + timeout_s
        while not self.backend.is_ready(handle):
            if self.clock() >= deadline:
                return False
            time.sleep(self.backend.poll_s)
        return True

    def _weight_payload(self, L: _LayerStream, e: int) -> Payload:
        return L.image.weight_payload(e)

    def _factor_payload(self, L: _LayerStream, e: int, windows) -> Payload:
        return L.image.factor_payload(e, windows, pin=self.backend.cuda)

    def _apply_weights(self, L: _LayerStream, e: int, dev: Payload):
        """Copy a landed weight payload into expert ``e``'s container
        slices (every leaf contiguous: one multi-tensor byte copy)."""
        torch._foreach_copy_(
            L.weight_dst(e),
            [dev.data[lf.offset:lf.offset + lf.nbytes] for lf in dev.leaves])
        L.valid.add(int(e))

    def _apply_factors(self, L: _LayerStream, e: int,
                       windows: Dict[str, Tuple[int, int]], dev: Payload,
                       cap):
        for name, leaves in dev.tree().items():
            lo, hi = windows[name]
            st = L.containers[name]
            st.u[e][:, lo:hi].copy_(leaves["u"])
            st.v[e][lo:hi].copy_(leaves["v"])
            st.u_scale[e][:, lo:hi].copy_(leaves["u_scale"])
            st.v_scale[e][lo:hi].copy_(leaves["v_scale"])
        L.raise_staged_cap(int(e), cap)

    def _integrate_slot(self, L: _LayerStream, slot: StagingSlot):
        dev = self.backend.payload(slot.handle)
        self.transfer_s += max(self.clock() - slot.t_issue, 0.0)
        if slot.kind == KIND_WEIGHTS:
            self._apply_weights(L, slot.expert, dev)
        else:
            windows, cap = slot.meta
            self._apply_factors(L, slot.expert, windows, dev, cap)
        self.backend.release(slot.handle)
        L.ring.release(slot)

    def integrate_ready(self, layer: Optional[int] = None):
        """Copy every completed in-flight copy into its container."""
        layers = self.layers if layer is None else [self.layers[layer]]
        for L in layers:
            for slot in L.ring.take_ready():
                self._integrate_slot(L, slot)

    def _issue_ring(self, L: _LayerStream, e: int, payload,
                    wire_bytes: int, kind: str, meta=None
                    ) -> Optional[StagingSlot]:
        slot = L.ring.try_issue(e, payload, wire_bytes, kind, meta)
        if slot is None:
            # drain completed copies; a freed slot lets the issue proceed
            self.integrate_ready(L.idx)
            slot = L.ring.try_issue(e, payload, wire_bytes, kind, meta)
        if slot is not None:
            self._count_issue(wire_bytes)
        return slot

    def _copy_now(self, L: _LayerStream, e: int, kind: str, payload,
                  wire_bytes: int, timeout_s: float, stall_clock: bool,
                  apply) -> bool:
        """Immediate copy outside the ring — the demand path, integrated
        before the next chunk decodes (the JAX engine blocks on it; on
        an ordered backend the device orders it instead).  Returns False
        when the copy stalled past the timeout (the container keeps its
        previous/fallback content)."""
        t0 = self.clock()
        handle = self.backend.copy(payload, tag=(L.idx, int(e), kind),
                                   staging=self._demand)
        self._count_issue(wire_bytes)
        # an ordered backend's copy is integrated behind its event on the
        # device; the host goes on to the next metering event
        ok = self.backend.ordered or self._wait_handle(handle, timeout_s)
        dt = self.clock() - t0
        if stall_clock:
            self.stalls += 1
            self.stall_s += dt
            self.transfer_s += dt
        else:
            self.sync_copy_s += dt
        if ok:
            apply(self.backend.payload(handle))
            self.backend.release(handle)
        else:
            self.abandoned_copies += 1
        return ok

    def _copy_weights_now(self, L: _LayerStream, e: int,
                          timeout_s: Optional[float] = None,
                          stall_clock: bool = False) -> bool:
        return self._copy_now(
            L, e, KIND_WEIGHTS, self._weight_payload(L, e),
            L.store.expert_bytes(e, self.policy),
            self.cfg.stall_timeout_s if timeout_s is None else timeout_s,
            stall_clock, lambda dev: self._apply_weights(L, e, dev))

    def _copy_factors_now(self, L: _LayerStream, e: int, windows, cap,
                          wire_bytes: int = 0,
                          stall_clock: bool = False) -> bool:
        if not windows:
            return True
        return self._copy_now(
            L, e, KIND_FACTORS,
            self._factor_payload(L, e, windows), wire_bytes,
            self.cfg.stall_timeout_s, stall_clock,
            lambda dev: self._apply_factors(L, e, windows, dev, cap))

    # -- store-driven hooks (the metering events) ---------------------------
    def _on_demand(self, l: int, store, e: int, nbytes: int):
        """A demand miss the store just charged ``nbytes`` for.  Consume
        the matching optimistically-staged copy, or perform one now."""
        L = self.layers[l]
        if L.ledger.pop((KIND_WEIGHTS, e), None) is not None:
            store.note_copy(nbytes)
            return
        self._copy_weights_now(L, e)
        store.note_copy(nbytes)

    def _on_factors(self, l: int, store, e: int, have, cap, nbytes: int):
        L = self.layers[l]
        entry = L.ledger.pop((KIND_FACTORS, e), None)
        if entry is not None:
            store.note_copy(nbytes)
            return
        windows = L.factor_windows(e, have, cap)
        self._copy_factors_now(L, e, windows, cap, wire_bytes=nbytes)
        store.note_copy(nbytes)

    def _on_prefetch(self, l: int, store, e: int, nbytes: int) -> bool:
        """Async prefetch issue; False (-> the store must not meter) when
        the staging ring cannot take the copy."""
        L = self.layers[l]
        if L.ring.find(e, KIND_WEIGHTS) is not None:
            return False                       # already in flight
        slot = self._issue_ring(L, e, self._weight_payload(L, e), nbytes,
                                KIND_WEIGHTS)
        if slot is None:
            return False
        store.note_copy(nbytes)
        return True

    # -- optimistic-execution support (serve engine) ------------------------
    def plan_vectors(self, layers: int, plan, static_top_n):
        """Per-layer (top_ns, caps) from a (layers, 2) [top_n, rank_cap]
        plan array, or None (the static plan)."""
        if plan is None:
            top_n, caps = static_top_n, None
        else:
            arr = np.asarray(plan)
            top_n, caps = arr[:, 0], arr[:, 1]
        return (_per_layer(top_n, layers, 1), _per_layer(caps, layers, None))

    def may_miss(self, top_ns, caps) -> bool:
        """Can the next chunk possibly route to an unstaged expert (or an
        under-staged compensator)?  False = the re-run machinery can be
        skipped entirely (warm steady state)."""
        for l, L in enumerate(self.layers):
            if len(L.valid) < L.image.num_experts:
                return True
            if self.policy == "ours" and top_ns[l] > 0:
                for e in range(L.image.num_experts):
                    if L.factor_deficit(e, caps[l]):
                        return True
        return False

    def missing_for_trace(self, trace: np.ndarray, active: np.ndarray,
                          top_ns, caps) -> List[Tuple[int, int, bool, Any]]:
        """Requirements the containers cannot serve for this routing.

        ``trace``: (steps, moe_layers, B, k) routed ids; ``active``: (B,)
        live-slot mask.  Returns [(layer, expert, need_weights,
        factor_cap-or-_NO_FACTORS)] covering every active routed expert
        whose true weights are not staged, plus (policy 'ours') every
        top-n routed expert whose staged factor rows fall short of the
        layer's rank cap."""
        trace = np.asarray(trace)
        needs: Dict[Tuple[int, int], List] = {}
        for l, L in enumerate(self.layers):
            sub = trace[:, l][:, np.asarray(active, bool)]   # (steps, A, k)
            ids = np.unique(sub[sub >= 0])
            for e in ids:
                if int(e) not in L.valid:
                    needs[(l, int(e))] = [True, _NO_FACTORS]
            if self.policy == "ours" and top_ns[l] > 0:
                tn = sub[..., :top_ns[l]]
                for e in np.unique(tn[tn >= 0]):
                    if L.factor_deficit(int(e), caps[l]):
                        needs.setdefault((l, int(e)),
                                         [False, _NO_FACTORS])[1] = caps[l]
        return [(l, e, w, f) for (l, e), (w, f) in sorted(needs.items())]

    def missing_for_forward_trace(self, trace, top_n: int
                                  ) -> List[Tuple[int, int, bool, Any]]:
        """Prefill variant: ``trace`` is the forward pass's
        (moe_layers, ..., k) routing (padded prompt positions included);
        prefill compensates at the static ``top_n`` with full rank."""
        arr = np.asarray(trace)
        k = arr.shape[-1]
        flat = arr.reshape(arr.shape[0], -1, k)[None]   # (1, layers, X, k)
        active = np.ones((flat.shape[2],), bool)
        layers = flat.shape[1]
        return self.missing_for_trace(flat, active, [top_n] * layers,
                                      [None] * layers)

    def _factor_need_bytes(self, L: _LayerStream, e: int, f_cap) -> int:
        have = L.staged_cap.get(e, -1)
        return (L.store.compensator_bytes(e, f_cap)
                - (0 if have == -1 else L.store.compensator_bytes(e, have)))

    def demand_stage(self, needs, timeout_s: Optional[float] = None
                     ) -> List[Tuple[int, int]]:
        """Block until every need is staged (the true-miss stall path).

        Waits on in-flight ring copies first (their bytes were already
        metered at prefetch issue); fresh copies go on the ledger so the
        replay's demand/compensator charges consume them.  Returns the
        (layer, expert) pairs that could NOT be staged (stalled copies)
        — the caller serves those from the resident low-bit fallback and
        counts the affected tokens as degraded."""
        timeout = self.cfg.stall_timeout_s if timeout_s is None \
            else timeout_s
        unresolved = []
        for (l, e, need_w, f_cap) in needs:
            L = self.layers[l]
            ok = True
            if need_w and e not in L.valid:
                slot = L.ring.find(e, KIND_WEIGHTS)
                if slot is not None:
                    t0 = self.clock()
                    got = L.ring.wait(slot, timeout)
                    dt = self.clock() - t0
                    self.stalls += 1
                    self.stall_s += dt
                    if got:
                        self._integrate_slot(L, slot)
                    else:
                        L.ring.abandon(slot)
                        self.abandoned_copies += 1
                        ok = False
                else:
                    nb = L.store.expert_bytes(e, self.policy)
                    L.ledger[(KIND_WEIGHTS, e)] = nb
                    ok = self._copy_weights_now(L, e, timeout_s=timeout,
                                                stall_clock=True)
            if ok and f_cap is not _NO_FACTORS and self.policy == "ours":
                windows = L.factor_deficit(e, f_cap)
                if windows:
                    nb = self._factor_need_bytes(L, e, f_cap)
                    L.ledger[(KIND_FACTORS, e)] = (nb, f_cap)
                    ok = self._copy_factors_now(L, e, windows, f_cap,
                                                wire_bytes=nb,
                                                stall_clock=True)
            if not ok:
                unresolved.append((l, e))
        return unresolved

    def stage_async(self, needs):
        """Degrade-mode background staging: issue what the ring can take
        now (ledgered at issue); declined issues retry on a later chunk."""
        for (l, e, need_w, f_cap) in needs:
            L = self.layers[l]
            if (need_w and e not in L.valid
                    and (KIND_WEIGHTS, e) not in L.ledger
                    and L.ring.find(e, KIND_WEIGHTS) is None):
                nb = L.store.expert_bytes(e, self.policy)
                slot = self._issue_ring(L, e, self._weight_payload(L, e),
                                        nb, KIND_WEIGHTS)
                if slot is not None:
                    L.ledger[(KIND_WEIGHTS, e)] = nb
            if (f_cap is not _NO_FACTORS and self.policy == "ours"
                    and (KIND_FACTORS, e) not in L.ledger
                    and L.ring.find(e, KIND_FACTORS) is None):
                windows = L.factor_deficit(e, f_cap)
                if windows:
                    nb = self._factor_need_bytes(L, e, f_cap)
                    slot = self._issue_ring(
                        L, e, self._factor_payload(L, e, windows), nb,
                        KIND_FACTORS, meta=(windows, f_cap))
                    if slot is not None:
                        L.ledger[(KIND_FACTORS, e)] = (nb, f_cap)

    def flush_unclaimed(self):
        """Chunk boundary: meter staged copies the accepted trace never
        touched into their store as (wasted) prefetch traffic, keeping
        metered bytes == observed copies exact."""
        for L in self.layers:
            for key in list(L.ledger):
                kind, e = key
                if kind == KIND_WEIGHTS:
                    nb = L.ledger.pop(key)
                    moved = L.store.absorb_external_copy(e, nb)
                else:
                    nb, cap = L.ledger.pop(key)
                    moved = L.store.absorb_external_copy(
                        e, 0, comp_rank=cap, comp_bytes=nb)
                L.store.wasted_prefetch_bytes += moved
                self.flushed_bytes += moved

    # -- degraded-token accounting ------------------------------------------
    @staticmethod
    def count_affected_tokens(trace: np.ndarray, active: np.ndarray,
                              bad: Iterable[Tuple[int, int]]) -> int:
        """Active (step, slot) tokens whose routing touched any (layer,
        expert) in ``bad`` — the tokens served by the low-bit fallback."""
        trace = np.asarray(trace)
        steps, _layers, b, _k = trace.shape
        mask = np.zeros((steps, b), bool)
        for (l, e) in bad:
            mask |= (trace[:, l] == e).any(axis=-1)
        mask &= np.asarray(active, bool)[None, :]
        return int(mask.sum())

    # -- reporting ----------------------------------------------------------
    def observed_totals(self) -> Tuple[int, int]:
        copies = sum(L.store.observed_copies for L in self.layers)
        nbytes = sum(L.store.observed_copy_bytes for L in self.layers)
        return copies, nbytes

    def report(self) -> Dict:
        copies, nbytes = self.observed_totals()
        metered = sum(L.store.total_bytes for L in self.layers)
        hidden = max(self.transfer_s - self.stall_s, 0.0)
        if self.transfer_s > 0:
            eff = hidden / self.transfer_s
        else:
            eff = 1.0 if self.issued_copies else 0.0
        return {
            "enabled": True,
            "miss_policy": self.cfg.miss_policy,
            "ring_slots": self.cfg.ring_slots,
            "fallback_bits": self.cfg.fallback_bits,
            "issued_copies": self.issued_copies,
            "issued_bytes": self.issued_bytes,
            "observed_copies": copies,
            "observed_copy_bytes": nbytes,
            "metered_bytes": metered,
            "stalls": self.stalls,
            "stall_s": self.stall_s,
            "transfer_s": self.transfer_s,
            "sync_copy_s": self.sync_copy_s,
            "overlap_efficiency": eff,
            "reruns": self.reruns,
            "degraded_tokens": self.degraded_tokens,
            "abandoned_copies": self.abandoned_copies,
            "flushed_bytes": self.flushed_bytes,
            "in_flight": sum(len(L.ring.in_flight()) for L in self.layers),
            "host_nbytes": sum(L.image.host_nbytes for L in self.layers),
        }
