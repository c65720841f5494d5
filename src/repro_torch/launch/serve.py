"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id> [...]``,
port of ``repro/launch/serve.py``.

Boots the reduced config (or the full one), initializes weights from
``--seed`` or restores compressed experts from an artifact, and serves
synthetic traffic through the continuous-batching engine — one
slot-indexed KV cache and one captured decode graph per bucket stay
resident while the scheduler admits, retires, and refills requests
between chunks:

- default: one fixed batch (``--batch`` x ``--prompt-len``), reporting
  prefill latency and decode tokens/s;
- ``--requests N``: a scheduled workload of N ragged-length requests
  (optionally arriving at ``--rate`` req/s) onto ``--slots`` decode
  slots in ``--chunk``-step chunks, reporting throughput and p50/p95
  request latency;
- ``--offload``: compress the MoE experts (low-bit + rank-padded
  compensators) and serve from byte-metered host-side expert stores,
  reporting live wire bytes/token and cache hit rate;
- ``--artifact DIR`` (with ``--offload``): boot from a compression
  artifact (``launch/compress.py``, of either package) instead of
  recompressing at startup, after a config-fingerprint + checksum check;
  serving equals in-memory compression of the same plan;
- ``--bytes-per-token B`` / ``--target-tokens-per-s T`` (with
  ``--offload``): the runtime bandwidth-budget controller retunes the
  per-layer (top_n, rank_cap) plan between chunks;
- ``--page-size P`` (with ``--requests``): a paged KV cache of P-token
  pages (a power of two), the pool sized to the workload's largest
  concurrent needs; ``--prefix-cache`` also shares the physical pages of
  common prompt prefixes (prints the ``pages`` line);
- ``--stream`` (with ``--offload``): async expert streaming — the experts
  live in a pinned host image and every metered byte is copied into the
  device containers the decode graph reads (``--stream-ring`` slots per
  layer, ``--stream-miss`` block | degrade, ``--stream-fallback-bits``);
- ``--spec-k K`` (with ``--requests``): speculative decoding, ``K``
  drafted tokens per slot per round from ``--drafter`` (ngram | model |
  self), verified in one pass (prints the ``speculative`` line);
- ``--mesh ep=N``: expert-parallel serving — N ranks (processes, started
  and joined here, meeting through a ``file://`` store) each serve the
  same traffic with their slice of the experts (and of their
  compensator factors), prefill dispatching by all-to-all and decode
  summing resident-expert partials by all-reduce; the offload meter
  splits into per-shard stores, and ``--budget-scope per_shard`` budgets
  the hottest shard's link.  ``--dist-backend`` picks the collectives'
  backend: ``nccl`` (default; one card per rank) or ``gloo`` (any number
  of ranks on one card, or CPU ranks).  Rank 0 prints the report, with
  the per-shard link bytes.

Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).  The compile count becomes ``ServeEngine.num_graphs`` (and
``num_spec_graphs``); a mesh engine decodes eagerly (no graphs).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .compress import PARAMS_INIT
from .mesh import BACKENDS, make_serve_mesh, parse_mesh_spec, run_ranks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve synthetic traffic through the continuous-"
                    "batching engine (scheduler + fixed-shape decode "
                    "chunks)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2,
                    help="fixed-batch mode: rows decoded side by side")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--requests", type=int, default=0,
                    help="schedule N ragged requests through the slot pool "
                         "instead of one fixed batch")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s (0 = all at t=0)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-slot pool size (batch rows)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per chunk; the scheduler refills "
                         "finished slots between chunks")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache page size (power of two; 0 = "
                         "contiguous per-slot buckets)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share physical KV pages across requests with a "
                         "common prompt prefix (needs --page-size)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft this many tokens "
                         "per slot per round and verify them in one "
                         "batched target pass (0 = off; needs "
                         "--requests; token-identical at temperature 0)")
    ap.add_argument("--drafter", default="ngram",
                    choices=("ngram", "model", "self"),
                    help="speculative drafter: backoff n-gram over each "
                         "slot's committed stream, a small random-init "
                         "dense draft model, or the serving model itself "
                         "re-read over a token window (the idealized "
                         "high-acceptance drafter)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda | cpu); cuda raises when "
                         "there is no CUDA device")
    ap.add_argument("--mesh", default="",
                    help="expert-parallel serving mesh, e.g. 'ep=4': "
                         "experts (and their compensator factors) "
                         "partition over that many ranks")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="collectives of --mesh: nccl (one card per rank) "
                         "or gloo (every rank on one card, or CPU ranks)")
    # -- offload + bandwidth-budget controller ---------------------------
    ap.add_argument("--offload", action="store_true",
                    help="compress MoE experts and meter offloaded serving "
                         "(wire bytes, cache hits) from live decode routing")
    ap.add_argument("--artifact", default="",
                    help="boot the compressed stacks from a "
                         "launch/compress.py artifact directory instead "
                         "of recompressing at startup (needs --offload)")
    ap.add_argument("--cache-experts", type=int, default=4,
                    help="device-resident expert LRU capacity per layer")
    ap.add_argument("--bytes-per-token", type=float, default=0.0,
                    help="bandwidth budget: adapt per-layer (top_n, "
                         "rank_cap) to this many wire bytes per token")
    ap.add_argument("--target-tokens-per-s", type=float, default=0.0,
                    help="bandwidth SLO: budget = link-bw / target tok/s")
    ap.add_argument("--link-bw", type=float, default=25e9,
                    help="link bandwidth (bytes/s) for --target-tokens-per-s")
    ap.add_argument("--budget-scope", default="aggregate",
                    choices=("aggregate", "per_shard"),
                    help="what the byte budget constrains under --mesh: "
                         "the summed links or the hottest shard's link")
    # -- async expert streaming -------------------------------------------
    ap.add_argument("--stream", action="store_true",
                    help="serve through the async expert-streaming engine "
                         "(needs --offload): experts live in pinned host "
                         "memory and stream into device containers via "
                         "per-layer staging rings; decode blocks only on "
                         "a true miss")
    ap.add_argument("--stream-ring", type=int, default=2,
                    help="staging-ring slots per layer (in-flight H2D "
                         "copies; 2 = double buffer)")
    ap.add_argument("--stream-miss", default="block",
                    choices=("block", "degrade"),
                    help="on a routed expert whose copy has not landed: "
                         "'block' stages + re-runs the chunk (token-"
                         "identical to all-resident), 'degrade' serves it "
                         "from the resident low-bit fallback")
    ap.add_argument("--stream-fallback-bits", type=int, default=2,
                    help="bit width of the device-resident fallback copy "
                         "that serves missed experts under 'degrade'")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    from ..registry import get_config
    ap = build_parser()
    args = ap.parse_args(argv)
    want_budget = args.bytes_per_token > 0 or args.target_tokens_per_s > 0
    if want_budget and not args.offload:
        ap.error("--bytes-per-token/--target-tokens-per-s need --offload "
                 "(the controller feeds on the offload byte meters)")
    if args.artifact and not args.offload:
        ap.error("--artifact needs --offload (it replaces the startup "
                 "compression of the offload path)")
    if args.stream and not args.offload:
        ap.error("--stream needs --offload (the stream engine is driven "
                 "by the offload stores' metering events)")
    if args.prefix_cache and args.page_size <= 0:
        ap.error("--prefix-cache needs --page-size (prefixes are shared "
                 "as pages)")
    if args.spec_k > 0 and args.requests <= 0:
        ap.error("--spec-k needs --requests (speculative rounds run "
                 "through the continuous-batching scheduler)")
    try:
        ep = parse_mesh_spec(args.mesh).get("ep", 1) if args.mesh else 1
    except ValueError as e:
        ap.error(str(e))
    if args.stream and ep > 1:
        ap.error("--stream requires the single-device serving path "
                 "(mesh-sharded streaming is not supported)")
    cfg = get_config(args.arch, reduced=not args.full_config)
    if args.offload and cfg.moe is None:
        ap.error(f"--offload needs an MoE arch; {cfg.name} has none")
    if ep > 1:
        # one process per shard, each running ``run``; rank 0 reports.
        # The ranks find ``_serve_rank`` by the module's import name
        # (under ``python -m`` this module is ``__main__``)
        from importlib import import_module
        rank_fn = import_module(__package__ + ".serve")._serve_rank
        ranks = run_ranks(rank_fn, ep, backend=args.dist_backend,
                          args=(cfg, args, ep))
        return {"ranks": ranks, **ranks[0]}
    return run(cfg, args)


def _serve_rank(rank: int, cfg, args, ep: int) -> Dict:
    """One rank of ``--mesh ep=N``: its mesh, then ``run``; the other
    ranks' output is silenced.  Returns what pickles of ``run``'s result
    (the stats or the generation result)."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    mesh = make_serve_mesh(ep, backend=args.dist_backend,
                           device="cpu" if args.device == "cpu" else None)
    out = run(cfg, args, mesh=mesh)
    return {k: out[k] for k in ("stats", "result", "load_s") if k in out}


def load_artifact_for(cfg, args, device):
    """(stacks_by_layer, plan, meta) of ``args.artifact``, checked against
    ``cfg``'s fingerprint, ``args.seed`` and the port's parameter init:
    an artifact compressed against other parameters is refused."""
    from ..calib import load_compression_artifact
    stacks_by_layer, plan, meta = load_compression_artifact(
        args.artifact, cfg, device=device)
    if meta.get("seed", 0) != args.seed:
        raise ValueError(f"artifact was compressed against params seed "
                         f"{meta.get('seed')}, serving seed {args.seed}")
    init = meta.get("extra", {}).get("params_init")
    if init != PARAMS_INIT:
        raise ValueError(
            f"artifact was compressed against params initialized by "
            f"{init or 'the JAX package'}; serving initializes them with "
            f"{PARAMS_INIT}, so seed {args.seed} names other weights")
    return stacks_by_layer, plan, meta


def run(cfg, args, mesh=None) -> Dict:
    """Boot and serve on ``cfg`` (``main`` passes the registry's; a caller
    may pass a depth-cut one), on one device or as one rank of ``mesh``
    (``launch.mesh.make_serve_mesh``; every rank calls ``run`` alike).
    Returns the engine, the stacks it serves (with ``--offload``), the
    seconds the artifact took to load (with ``--artifact``) and the
    ``ServeStats`` (``--requests``) or ``GenerationResult`` (fixed
    batch)."""
    from ..config import ControlConfig, StreamConfig
    from ..models.transformer import (apply_compressed_stacks,
                                      compress_moe_params, init_params)
    from ..serve import ServeEngine, synthetic_workload

    dev = resolve_device(args.device) if mesh is None else mesh.device
    if cfg.rope_kind == "mrope":
        print(f"note: {cfg.name} needs frontend inputs; serving the "
              f"text-only path")
    want_budget = args.bytes_per_token > 0 or args.target_tokens_per_s > 0
    # params follow --seed on both paths, so `--offload` (in-memory
    # compression) and `--offload --artifact` compare at any seed
    params = init_params(cfg, args.seed, torch.float32, dev)
    stacks_by_layer, load_s = None, None
    if args.offload:
        if args.artifact:
            t0 = time.perf_counter()
            stacks_by_layer, plan, meta = load_artifact_for(cfg, args, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            load_s = time.perf_counter() - t0
            qparams, cfg_q = apply_compressed_stacks(params, cfg,
                                                     stacks_by_layer)
            print(f"booted artifact {args.artifact}: "
                  f"{meta['moe_layers']} MoE layers, "
                  f"plan={'none (uniform)' if plan is None else plan.scorer},"
                  f" checksum ok — no startup recompression")
        else:
            qparams, cfg_q, stacks_by_layer = compress_moe_params(params,
                                                                  cfg)
        del params
        eng = ServeEngine(cfg_q, qparams, quantized=True, device=dev,
                          mesh=mesh)
        eng.attach_offload(stacks_by_layer, policy="ours",
                           cache_capacity=args.cache_experts)
        if want_budget:
            eng.attach_controller(ControlConfig(
                enabled=True, bytes_per_token=args.bytes_per_token,
                tokens_per_s=args.target_tokens_per_s,
                link_bw=args.link_bw, budget_scope=args.budget_scope))
        if args.stream:
            eng.attach_streaming(StreamConfig(
                enabled=True, ring_slots=args.stream_ring,
                miss_policy=args.stream_miss,
                fallback_bits=args.stream_fallback_bits))
    else:
        eng = ServeEngine(cfg, params, device=dev, mesh=mesh)
    out = {"engine": eng, "stacks_by_layer": stacks_by_layer,
           "load_s": load_s}

    if args.requests > 0:
        reqs = synthetic_workload(
            args.requests, cfg.vocab_size, rate=args.rate,
            max_new=args.max_new, min_len=max(args.prompt_len // 2, 1),
            max_len=args.prompt_len, seed=args.seed)
        stats = eng.serve(reqs, num_slots=args.slots, chunk=args.chunk,
                          seed=args.seed, page_size=args.page_size,
                          prefix_cache=args.prefix_cache,
                          spec_k=args.spec_k,
                          drafter=args.drafter if args.spec_k > 0 else None)
        out["stats"] = stats
        lat = stats.latency_percentiles((50.0, 95.0))
        print(f"{cfg.name}: {args.requests} requests on {args.slots} slots "
              f"(chunk {args.chunk}, rate "
              f"{args.rate if args.rate > 0 else 'closed-loop'}): "
              f"{stats.tokens_per_s:.1f} tok/s, "
              f"latency p50 {lat[50.0] * 1e3:.0f}ms "
              f"p95 {lat[95.0] * 1e3:.0f}ms, "
              f"{stats.chunks} chunks, graphs {eng.num_graphs}"
              + (f" + {eng.num_spec_graphs} verify" if args.spec_k > 0
                 else ""))
        print(f"cache: {stats.cache_hbm_bytes / 2**20:.2f} MiB HBM "
              f"({stats.cache_hbm_bytes_per_token / 2**10:.1f} KiB/token), "
              f"{stats.prefill_tokens} prefill tokens")
        pr = stats.page_report
        if pr is not None:
            print(f"pages ({pr['num_pages']}x{pr['page_size']}): "
                  f"{pr['allocs']} allocs, prefix hit "
                  f"{pr['prefix_hit_rate']:.0%} "
                  f"({pr['prefix_hits']}/{pr['prefix_queries']}), "
                  f"peak shared ref {pr['peak_shared_ref']}, "
                  f"{pr['evictions']} evictions")
        rep = stats.offload_report
        if rep is not None:
            print(f"offload ({rep['policy']}): "
                  f"{rep['bytes_per_token'] / 2**10:.1f} KiB/token, "
                  f"cache hit {rep['hit_rate']:.0%}, prefetch accuracy "
                  f"{rep['prefetch_accuracy']:.0%}")
            if rep["ep"] > 1:
                shares = ", ".join(f"{b / 2**10:.0f}"
                                   for b in rep["per_shard_bytes"])
                print(f"  per-shard links (ep={rep['ep']}): [{shares}] KiB, "
                      f"hottest {rep['max_shard_bytes_per_token'] / 2**10:.1f}"
                      f" KiB/token")
        sp = stats.spec_report
        if sp is not None:
            la = sp["lookahead_accuracy"]
            print(f"speculative (k={sp['spec_k']}, {sp['drafter']}): "
                  f"acceptance {sp['acceptance_rate']:.0%} "
                  f"({sp['accepted_draft_tokens']}/{sp['drafted_tokens']} "
                  f"drafts over {sp['rounds']} rounds), lookahead "
                  f"prefetch accuracy "
                  f"{'n/a' if la is None else format(la, '.0%')}, "
                  f"draft overhead "
                  f"{sp['draft_overhead_bytes'] / 2**10:.1f} KiB")
        sr = stats.stream_report
        if sr is not None:
            print(f"stream ({sr['miss_policy']}, ring {sr['ring_slots']}): "
                  f"overlap {sr['overlap_efficiency']:.0%}, "
                  f"{sr['observed_copies']} copies "
                  f"({sr['observed_copy_bytes'] / 2**20:.1f} MiB observed "
                  f"== {sr['metered_bytes'] / 2**20:.1f} MiB metered), "
                  f"{sr['stalls']} stalls ({sr['stall_s'] * 1e3:.0f}ms), "
                  f"{sr['reruns']} re-runs, "
                  f"{sr['degraded_tokens']} degraded tokens")
        if eng.controller is not None and eng.controller.history:
            c = eng.controller
            tail = c.history[len(c.history) // 2:]
            meas = float(np.mean([h.bytes_per_token for h in tail]))
            plan = c.plan().summary()
            print(f"controller: budget "
                  f"{c.ccfg.target_bytes_per_token / 2**10:.1f} KiB/token, "
                  f"converged tail {meas / 2**10:.1f} KiB/token "
                  f"({len(c.history)} updates), plan mean top_n "
                  f"{plan['mean_top_n']:.2f} rank_cap "
                  f"{plan['mean_rank_cap']:.1f}")
        return out

    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    res = eng.generate(prompts, max_new=args.max_new)
    out["result"] = res
    print(f"{cfg.name}: prefill {res.prefill_s * 1e3:.0f}ms, "
          f"decode {res.decode_tokens_per_s:.1f} tok/s "
          f"({args.batch}x{args.max_new} tokens)")
    if res.offload_report is not None:
        rep = res.offload_report
        print(f"offload ({rep['policy']}): "
              f"{rep['bytes_per_token'] / 2**10:.1f} KiB/token, "
              f"cache hit {rep['hit_rate']:.0%}")
    if res.stream_report is not None:
        sr = res.stream_report
        print(f"stream ({sr['miss_policy']}, ring {sr['ring_slots']}): "
              f"overlap {sr['overlap_efficiency']:.0%}, "
              f"{sr['observed_copies']} copies "
              f"({sr['observed_copy_bytes'] / 2**20:.1f} MiB observed == "
              f"{sr['metered_bytes'] / 2**20:.1f} MiB metered), "
              f"{sr['stalls']} stalls, {sr['degraded_tokens']} degraded "
              f"tokens")
    return out


if __name__ == "__main__":
    main()
