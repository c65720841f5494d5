"""Event-driven throughput simulator for offloaded MoE decoding (Fig 7).

Port of ``repro/offload/simulator.py``.  Replays real router traces
(``serve.engine.router_trace`` or a serve run's masked trace) through a two-resource
pipeline — transfer link and compute device — with double buffering:
layer l+1's expert fetch overlaps layer l's compute, exactly the
Mixtral-Offloading execution model.  Policies:

  fp16           Mixtral-Offloading: fetch fp16 experts on demand
  quant          HOBBIT-style low-bit uniform fetch
  ours           BEAM-LRC: low-bit fetch + top-n compensators (paper)
  ours_adaptive  BEAM-LRC under the runtime bandwidth-budget controller
                 (serve/controller.py): per-layer (top_n, rank_cap)
                 adapted online to a bytes/token budget
  *_ndp          MoNDE-style: cold experts execute on the NDP in low
                 precision, only top-n compensated experts run on the
                 fast device

Reported tokens/s is per request stream (batch 1 decode, the paper's
setting), with expert compute times from the hardware profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ControlConfig
from .bandwidth import GPU_NDP, GPU_ONLY, HardwareProfile
from .store import ExpertCache


@dataclasses.dataclass
class LayerSpecSim:
    """Static per-layer description of the MoE being served."""
    d_model: int
    d_expert: int
    num_experts: int
    top_k: int
    bytes_fp16: int          # per expert, all projections
    bytes_quant: int         # per expert, packed low-bit + scales
    comp_bytes: Sequence[int]  # per expert compensator bytes (true ranks)
    # per-expert true compensator ranks — required by the adaptive policy
    # (rank_cap scales comp_bytes by min(rank, cap) / rank)
    ranks: Optional[Sequence[int]] = None


@dataclasses.dataclass
class SimResult:
    tokens_per_s: float
    transfer_bytes_per_token: float
    transfer_time_frac: float
    cache_hit_rate: float
    compute_time_frac: float
    # adaptive-policy telemetry (0.0 under the static policies)
    mean_top_n: float = 0.0
    mean_rank_cap: float = 0.0
    # bytes/token over the second half of the trace — the converged
    # operating point once the controller's transient has settled
    # (equals the plain average under static policies)
    tail_bytes_per_token: float = 0.0


def expert_flops(spec: LayerSpecSim) -> float:
    return 2.0 * 3 * spec.d_model * spec.d_expert


def _capped_comp_bytes(spec: LayerSpecSim, e: int, cap: Optional[int]) -> int:
    cb = int(spec.comp_bytes[e])
    if cap is None or spec.ranks is None:
        return cb
    r = int(spec.ranks[e])
    return int(cb * min(r, int(cap)) / r) if r > 0 else 0


def simulate_decode(trace: np.ndarray, spec: LayerSpecSim,
                    profile: HardwareProfile, policy: str, *,
                    top_n: int = 1, cache_capacity: int = 2,
                    num_layers: int = 32, prefetch: bool = False,
                    control: Optional[ControlConfig] = None,
                    ctrl_interval: int = 4) -> SimResult:
    """trace: (tokens, layers, top_k) routed expert ids.

    Two-resource pipeline (link, device).  On-demand mode (default,
    Mixtral-Offloading semantics): a layer's fetch is issued only after the
    previous layer computed (the router decides what to fetch).  With
    ``prefetch=True`` the fetch is issued as soon as the link is free AND
    the layer-ahead prediction exists — the prediction for layer ``l``
    becomes available when layer ``l``'s router last ran (the previous
    token's pass), matching the real transfer engine's
    ``LayerAheadPrefetcher``: a first-touch layer has no prediction yet
    and falls back to on-demand issue.

    ``policy='ours_adaptive'`` (or ``'ours_adaptive_ndp'``) runs the
    bandwidth-budget controller in the loop: every ``ctrl_interval``
    tokens the link bytes moved since the last update feed
    ``BandwidthController.update`` and the per-layer (top_n, rank_cap)
    plan of the *next* tokens follows ``control``'s budget.  The
    controller sees only byte counters, so the simulation stays
    deterministic for a given trace + budget.
    """
    ndp = policy.endswith("_ndp")
    base_policy = policy.replace("_ndp", "")
    adaptive = base_policy == "ours_adaptive"
    if adaptive:
        base_policy = "ours"
        if control is None:
            raise ValueError("policy 'ours_adaptive' needs a ControlConfig")
        if spec.ranks is None:
            raise ValueError("policy 'ours_adaptive' needs LayerSpecSim."
                             "ranks (per-expert true compensator ranks)")
        from ..serve.controller import BandwidthController
        pad = max(int(r) for r in spec.ranks)
        ctrl = BandwidthController([pad] * trace.shape[1], spec.top_k,
                                   control, static_top_n=top_n)
        plan = ctrl.plan()
    else:
        ctrl = None
        plan = None
    caches = [ExpertCache(cache_capacity) for _ in range(num_layers)]
    # per-cache resident compensator rank caps, ExpertStore._comp_resident
    # semantics (e -> cap, None = full rank, absent = none resident):
    # factors ride the cache with their expert, a later cap raise moves
    # only the delta rows — keeps sim bytes identical to the store meter
    comp_res: List[Dict[int, Optional[int]]] = [{} for _ in range(num_layers)]
    # prediction availability per trace layer: the time layer l's router
    # last ran (None until first touch — no prediction to act on yet)
    pred_ready: List[Optional[float]] = [None] * trace.shape[1]
    t_link = 0.0      # link busy-until
    t_dev = 0.0       # device busy-until
    busy_link = 0.0
    busy_dev = 0.0
    total_bytes = 0
    half_bytes = 0
    eflops = expert_flops(spec)
    ctrl_bytes_mark = 0
    plan_sum = np.zeros((2,), np.float64)
    plan_obs = 0

    tokens = trace.shape[0]
    for tok in range(tokens):
        for layer in range(trace.shape[1]):
            cache = caches[layer % num_layers]
            resident = comp_res[layer % num_layers]
            experts = trace[tok, layer]
            if plan is not None:
                layer_top_n = int(plan.top_n[layer])
                layer_cap = int(plan.rank_cap[layer])
                plan_sum += (layer_top_n, layer_cap)
                plan_obs += 1
            else:
                layer_top_n, layer_cap = top_n, None
            move = 0
            dev_flops = 0.0
            dev_bytes = 0.0
            ndp_time = 0.0
            for rank, e in enumerate(experts):
                e = int(e)
                restored = base_policy == "ours" and rank < layer_top_n
                if ndp and not restored:
                    # cold expert executes near-data in low precision
                    ndp_time += profile.ndp_compute_time(
                        eflops, spec.bytes_quant)
                    continue
                nbytes = (spec.bytes_fp16 if base_policy == "fp16"
                          else spec.bytes_quant)
                if not cache.access(e, nbytes):
                    move += nbytes
                if cache.last_evicted is not None:
                    resident.pop(cache.last_evicted, None)
                if restored:
                    # compensators ride the cache with their expert
                    # (ExpertStore.access_token semantics): fetch only the
                    # rank rows not already resident
                    have = resident.get(e, -1)        # -1 = absent
                    need = _capped_comp_bytes(spec, e, layer_cap)
                    if have is not None:
                        held = (0 if have < 0
                                else _capped_comp_bytes(spec, e, have))
                        if need > held:
                            move += need - held
                        if (have < 0 or layer_cap is None
                                or layer_cap > have):
                            resident[e] = layer_cap
                    nbytes += need
                dev_flops += eflops
                dev_bytes += nbytes
            # fetch issue time: on-demand waits for the router (= prev
            # layer's compute); prefetch for the link AND the layer-ahead
            # prediction (causal: layer l's router must have run once)
            if prefetch and pred_ready[layer] is not None:
                issue = max(t_link, pred_ready[layer])
            else:
                issue = max(t_link, t_dev)
            tt = profile.transfer_time(move) if move else 0.0
            t_ready = issue + tt
            t_link = t_ready
            busy_link += tt
            # device: compute is max(flop-time, weight-streaming from HBM)
            comp = max(profile.compute_time(dev_flops),
                       profile.hbm_time(dev_bytes))
            start = max(t_ready, t_dev)
            # layer l's router runs as its compute begins: from here on a
            # prefetch of the NEXT token's layer-l prediction may issue
            pred_ready[layer] = start
            t_dev = start + comp + ndp_time
            busy_dev += comp + ndp_time
            total_bytes += move
        if tok + 1 == tokens // 2:
            half_bytes = total_bytes
        if ctrl is not None and (tok + 1) % ctrl_interval == 0:
            plan = ctrl.update(total_bytes - ctrl_bytes_mark, ctrl_interval)
            ctrl_bytes_mark = total_bytes
    wall = max(t_link, t_dev)
    hit = float(np.mean([c.stats.hit_rate for c in caches]))
    mean_tn, mean_rc = ((plan_sum / plan_obs).tolist() if plan_obs
                        else (0.0, 0.0))
    return SimResult(
        tokens_per_s=tokens / wall if wall > 0 else float("inf"),
        transfer_bytes_per_token=total_bytes / tokens,
        transfer_time_frac=busy_link / wall if wall else 0.0,
        cache_hit_rate=hit,
        compute_time_frac=busy_dev / wall if wall else 0.0,
        mean_top_n=float(mean_tn), mean_rank_cap=float(mean_rc),
        tail_bytes_per_token=((total_bytes - half_bytes)
                              / max(tokens - tokens // 2, 1)))


def make_router_trace(probs_fn, tokens: int, layers: int, top_k: int,
                      seed: int = 0, skew: float = 0.0,
                      num_experts: int = 8) -> np.ndarray:
    """Synthetic fallback trace with controllable router skew (benchmarks
    prefer real traces exported from the JAX model)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((tokens, layers, top_k), np.int64)
    base = rng.dirichlet(np.ones(num_experts) * (1.0 - skew + 0.05),
                         size=layers)
    for t in range(tokens):
        for l in range(layers):
            p = base[l] + rng.dirichlet(np.ones(num_experts)) * 0.3
            p /= p.sum()
            out[t, l] = np.argsort(-p)[:top_k]
    return out
