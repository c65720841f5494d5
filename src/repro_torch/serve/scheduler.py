"""Continuous-batching request scheduler (a copy of
``repro/serve/scheduler.py``; numpy only).

The engine keeps ONE fixed-shape decode state — a slot-indexed KV cache
of ``num_slots`` batch rows and a decode chunk replayed from one
captured step — and this module owns everything request-shaped around
it: the FIFO admission queue, slot assignment, per-request EOS /
max-token termination, and refilling completed slots from the queue
between chunks.  Decode shapes never change while requests come and go.

Request lifecycle::

    submit() ──► queue ──admit()──► slot (prefill + cache claim by engine)
                                     │  record_chunk() appends tokens,
                                     │  detects EOS / length termination
                                     ▼
                                  finished (RequestResult), slot freed
                                     │
                                     └──► next admit() refills the slot

``record_chunk`` also returns the per-step slot-activity mask so the
engine can mask retired/empty slots out of the router trace (expert id
-1) before offload metering — inactive slots keep decoding garbage to
preserve shapes, but none of it reaches results or the wire-byte meter.

The chunk boundary is also where the engine applies runtime control:
after ``record_chunk`` the masked trace is metered into the expert
stores and the bandwidth controller (``serve/controller.py``) digests
the chunk's wire bytes into the next chunk's per-layer ``(top_n,
rank_cap)`` restoration plan — slots and shapes never change, only the
plan *data* fed to the next chunk.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request."""
    uid: int
    tokens: np.ndarray                 # (plen,) int32 prompt ids
    max_new: int = 32
    eos_id: Optional[int] = None       # None = never terminate on a token
    arrival_s: float = 0.0             # offered-load arrival (relative s)

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclasses.dataclass
class RequestResult:
    """Completed request: generated stream + per-request telemetry."""
    uid: int
    prompt_len: int
    tokens: np.ndarray                 # (gen,) generated ids (incl. EOS)
    logprobs: np.ndarray               # (gen,)
    trace: Optional[np.ndarray]        # (gen, moe_layers, k) or None
    finish_reason: str                 # 'eos' | 'length'
    arrival_s: float
    admitted_s: float
    first_token_s: float
    finished_s: float
    offload_bytes: int = 0             # demand+compensator bytes attributed

    @property
    def gen_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token from arrival; NaN for requests that
        retired before emitting any token (max_new <= 0)."""
        return self.first_token_s - self.arrival_s


@dataclasses.dataclass
class _Active:
    """In-flight request pinned to a slot."""
    req: Request
    slot: int
    admitted_s: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    trace: List[np.ndarray] = dataclasses.field(default_factory=list)
    first_token_s: float = -1.0
    offload_bytes: int = 0


class Scheduler:
    """FIFO admission onto a fixed pool of decode slots."""

    def __init__(self, num_slots: int):
        assert num_slots >= 1
        self.num_slots = num_slots
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[_Active]] = [None] * num_slots
        self.finished: List[RequestResult] = []
        self._finished_by_uid: Dict[int, RequestResult] = {}

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return bool(self.queue) or self.num_active > 0

    def next_arrival(self) -> Optional[float]:
        return self.queue[0].arrival_s if self.queue else None

    # -- admission --------------------------------------------------------
    def admit(self, now: float = float("inf")
              ) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue head (FIFO; only requests whose
        arrival time has passed).  Returns the (slot, request) pairs so
        the engine can prefill and claim the cache rows."""
        out = []
        for i in range(self.num_slots):
            if self.slots[i] is not None:
                continue
            if not self.queue or self.queue[0].arrival_s > now:
                break
            req = self.queue.popleft()
            self.slots[i] = _Active(req, i, admitted_s=now)
            out.append((i, req))
        return out

    def active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], bool)

    def uid_by_slot(self) -> Dict[int, int]:
        return {i: s.req.uid for i, s in enumerate(self.slots)
                if s is not None}

    # -- chunk bookkeeping -------------------------------------------------
    def record_chunk(self, tokens: np.ndarray, logprobs: np.ndarray,
                     trace: Optional[np.ndarray], now: float,
                     t_start: Optional[float] = None,
                     valid_len: Optional[np.ndarray] = None) -> np.ndarray:
        """Consume one decode chunk.

        ``tokens``/``logprobs``: (num_slots, chunk); ``trace``:
        (chunk, moe_layers, num_slots, k) or None.  Appends each active
        slot's tokens until its EOS or max-token budget, retires finished
        requests (freeing the slot for the next ``admit``), and returns
        the (chunk, num_slots) bool mask of *accepted* steps — the mask
        the engine applies to the router trace before metering.

        ``t_start``: wall time when the chunk's decode began.  Per-step
        completion times interpolate linearly between ``t_start`` and
        ``now``, so first-token / finish stamps land on their step rather
        than quantizing to the chunk boundary (which inflated reported
        TTFT by up to ``chunk`` steps).  ``t_start=None`` keeps the old
        chunk-end stamping (every step stamps ``now``).

        ``valid_len``: optional (num_slots,) per-slot cap on how many of
        the chunk's steps are consumable — the speculative decoder's
        verify-accepted lengths.  A rejected draft suffix still occupies
        fixed-shape chunk positions but must never reach results; steps
        at c >= valid_len[slot] are skipped exactly like steps past a
        retirement.  ``None`` = every step is consumable (non-speculative
        chunks).
        """
        chunk = tokens.shape[1]

        def step_t(c: int) -> float:
            if t_start is None:
                return now
            return t_start + (c + 1) * (now - t_start) / chunk

        accepted = np.zeros((chunk, self.num_slots), bool)
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            done = None
            done_t = now
            lim = chunk if valid_len is None else int(valid_len[i])
            for c in range(chunk):
                if c >= lim:                  # rejected speculative suffix
                    break
                if len(st.tokens) >= st.req.max_new:   # max_new <= 0 case
                    done = "length"
                    # no step ran for this request; it was done on entry
                    done_t = t_start if t_start is not None else now
                    break
                tok = int(tokens[i, c])
                st.tokens.append(tok)
                st.logprobs.append(float(logprobs[i, c]))
                if trace is not None:
                    st.trace.append(trace[c, :, i, :])
                accepted[c, i] = True
                if st.first_token_s < 0:
                    st.first_token_s = step_t(c)
                if st.req.eos_id is not None and tok == st.req.eos_id:
                    done = "eos"
                elif len(st.tokens) >= st.req.max_new:
                    done = "length"
                if done:
                    done_t = step_t(c)
                    break
            if done:
                self._retire(i, done, done_t)
        return accepted

    def _retire(self, slot: int, reason: str, now: float):
        st = self.slots[slot]
        # a request retired before emitting any token (max_new <= 0) has
        # no first-token time; NaN is the explicit sentinel (the -1.0
        # placeholder used to leak in and skew latency aggregates)
        first = st.first_token_s if st.first_token_s >= 0 else float("nan")
        res = RequestResult(
            uid=st.req.uid, prompt_len=st.req.prompt_len,
            tokens=np.asarray(st.tokens, np.int32),
            logprobs=np.asarray(st.logprobs, np.float32),
            trace=(np.stack(st.trace) if st.trace else None),
            finish_reason=reason, arrival_s=st.req.arrival_s,
            admitted_s=st.admitted_s, first_token_s=first,
            finished_s=now, offload_bytes=st.offload_bytes)
        self.finished.append(res)
        self._finished_by_uid[res.uid] = res
        self.slots[slot] = None

    def add_slot_bytes(self, slot_bytes: np.ndarray,
                       uid_by_slot: Dict[int, int]):
        """Attribute per-slot metered bytes (replay_decode_trace) to the
        requests that occupied those slots during the chunk — they may
        have retired in record_chunk, so match by uid."""
        still_active = {st.req.uid: st for st in self.slots
                        if st is not None}
        for i, uid in uid_by_slot.items():
            nb = int(slot_bytes[i])
            if uid in still_active:
                still_active[uid].offload_bytes += nb
            elif uid in self._finished_by_uid:
                self._finished_by_uid[uid].offload_bytes += nb


def synthetic_workload(n: int, vocab_size: int, *, rate: float = 0.0,
                       max_new: int = 16, min_len: int = 6,
                       max_len: int = 24, seed: int = 0) -> List[Request]:
    """Ragged synthetic requests for serving benchmarks / CLI smoke runs.

    Prompt lengths are uniform in [min_len, max_len]; arrivals are
    Poisson at ``rate`` requests/s (rate <= 0: closed loop, everything
    at t=0), shifted so the first request arrives at t=0.  One generator
    shared by ``launch/serve.py --requests`` and
    ``benchmarks/bench_serving.py`` so the CLI and the benchmark always
    offer the same workload for the same rate."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, n)
    if rate > 0:
        gaps = rng.exponential(1.0 / rate, n)
        arrivals = np.cumsum(gaps) - gaps[0]
    else:
        arrivals = np.zeros(n)
    return [Request(uid=i,
                    tokens=rng.integers(0, vocab_size, (int(l),),
                                        dtype=np.int32),
                    max_new=max_new, arrival_s=float(t))
            for i, (l, t) in enumerate(zip(lens, arrivals))]
