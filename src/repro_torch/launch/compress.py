"""Offline compression CLI: ``python -m repro_torch.launch.compress --arch
<id> --out <dir> [...]`` — the calibrate → allocate → compress → artifact
pipeline (``calib/``), port of ``repro/launch/compress.py``.

1. **calibrate**: run the deterministic synthetic corpus through the
   forward (router trace + MoE-input collection) and accumulate
   per-expert routing frequency, gate mass, and input/hidden second
   moments per MoE layer;
2. **allocate**: water-filling/knapsack assignment of per-expert
   bit-widths and per-(projection, expert) compensator ranks under a
   global wire-byte budget (``--budget-bytes``, or ``--budget-frac`` of
   the uniform reference point), scored by ``--scorer``;
3. **compress**: the full pipeline with the allocated plan and
   moment-whitened compensator factorizations;
4. **artifact**: serialize plan + packed stacks with a config
   fingerprint, so ``launch/serve.py --artifact <dir>`` boots without
   recompressing.

With no budget flags the tool compresses on the paper's kurtosis-guided
uniform-bit path and still writes an artifact.  Everything runs on
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
The parameters come from the port's ``init_params`` at ``--seed``; the
manifest records ``extra["params_init"] = "repro_torch"``, since a seed
names parameters only within one framework.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from .. import resolve_device

PARAMS_INIT = "repro_torch"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="offline calibration + heterogeneous precision "
                    "allocation -> serialized compression artifact")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--out", required=True,
                    help="artifact directory (created if missing)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="param-init seed (recorded in the manifest; "
                         "serve --artifact must boot the same params)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda | cpu); cuda raises when "
                         "there is no CUDA device")
    # -- calibration ------------------------------------------------------
    ap.add_argument("--calib-batches", type=int, default=4,
                    help="calibration corpus size (synthetic batches)")
    ap.add_argument("--calib-batch-size", type=int, default=8)
    ap.add_argument("--calib-seq-len", type=int, default=128)
    # -- allocation -------------------------------------------------------
    ap.add_argument("--budget-bytes", type=float, default=0.0,
                    help="global wire-byte budget for weights + "
                         "compensators (0 = no budgeted allocation: "
                         "uniform-bit kurtosis-guided pipeline)")
    ap.add_argument("--budget-frac", type=float, default=0.0,
                    help="budget as a fraction of the uniform reference "
                         "(every expert at --bits with the configured "
                         "rank budget); overrides --budget-bytes")
    ap.add_argument("--scorer", default="calibrated",
                    choices=("calibrated", "kurtosis", "uniform"),
                    help="importance scorer weighting per-expert errors "
                         "in the allocator objective")
    ap.add_argument("--bits-candidates", default="2,3,4,8",
                    help="comma-separated per-expert width candidates")
    ap.add_argument("--no-whiten", action="store_true",
                    help="plain weight-space compensator SVDs (ablation; "
                         "default whitens by the calibrated moments)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    from ..registry import get_config
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=not args.full_config)
    if cfg.moe is None:
        ap.error(f"--arch {args.arch} has no MoE layers to compress")
    return run(cfg, args)


def run(cfg, args) -> Dict:
    """The four stages on ``cfg`` (``main`` passes the registry's; a
    caller may pass a depth-cut one).  Returns the manifest, the
    in-memory stacks and plan, the calibration stats and the seconds of
    each stage (device work finished at each stage's end)."""
    from ..calib import (allocate_budget, collect_calibration_stats,
                         moe_weights_by_layer, save_compression_artifact,
                         stacks_wire_bytes, stats_summary, uniform_plan,
                         weighted_restoration_error)
    from ..models.transformer import compress_moe_params, init_params

    dev = resolve_device(args.device)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    seconds = {}
    t0 = now()
    params = init_params(cfg, args.seed, torch.float32, dev)
    qcfg = cfg.moe.quant
    bits_candidates = tuple(int(b) for b in
                            args.bits_candidates.split(","))
    t1 = now()
    seconds["init"] = t1 - t0

    print(f"[1/4] calibrating {cfg.name}: {args.calib_batches} batches of "
          f"{args.calib_batch_size}x{args.calib_seq_len} synthetic tokens")
    stats = collect_calibration_stats(
        cfg, params, batches=args.calib_batches,
        batch_size=args.calib_batch_size, seq_len=args.calib_seq_len,
        seed=args.seed)
    summ = stats_summary(stats)
    print(f"      {summ['layers']} MoE layers, {summ['tokens']} tokens; "
          f"layer-0 importance {summ['importance'][0]}")
    t2 = now()
    seconds["calibrate"] = t2 - t1

    weights = moe_weights_by_layer(params, cfg)
    plan = None
    if args.budget_frac > 0 or args.budget_bytes > 0:
        ref = uniform_plan(weights, qcfg, bits=qcfg.bits,
                           rank=qcfg.rank_budget)
        budget = (args.budget_frac * ref.spent_bytes
                  if args.budget_frac > 0 else args.budget_bytes)
        print(f"[2/4] allocating under {budget / 2**10:.1f} KiB budget "
              f"(uniform ref {ref.spent_bytes / 2**10:.1f} KiB, scorer "
              f"{args.scorer}, bits {bits_candidates})")
        plan = allocate_budget(weights, qcfg, budget, stats=stats,
                               scorer=args.scorer,
                               bits_candidates=bits_candidates)
        ps = plan.summary()
        print(f"      spent {ps['spent_bytes'] / 2**10:.1f} KiB, mean bits "
              f"{ps['mean_bits']:.2f} (hist {ps['bits_hist']}), mean rank "
              f"{ps['mean_rank']:.1f}, predicted weighted err "
              f"{plan.predicted_err:.4f}")
    else:
        print("[2/4] no budget given: kurtosis-guided uniform-bit "
              "allocation (paper default)")
    t3 = now()
    seconds["allocate"] = t3 - t2

    print("[3/4] compressing (HQQ + "
          + ("weight-space" if args.no_whiten else "activation-whitened")
          + " residual SVDs)")
    _, _, stacks_by_layer = compress_moe_params(
        params, cfg, plan=plan, stats=None if args.no_whiten else stats)
    imps = [s.importance() for s in stats]
    err = weighted_restoration_error(stacks_by_layer, weights, imps)
    total = stacks_wire_bytes(stacks_by_layer)
    print(f"      artifact wire bytes {total / 2**10:.1f} KiB, "
          f"routing-weighted restoration error {err:.4f}")
    del params, weights
    t4 = now()
    seconds["compress"] = t4 - t3

    print(f"[4/4] writing artifact -> {args.out}")
    manifest = save_compression_artifact(
        args.out, cfg, stacks_by_layer, plan=plan, seed=args.seed,
        extra={"weighted_restoration_err": err,
               "wire_bytes": total,
               "calib": {"batches": args.calib_batches,
                         "batch_size": args.calib_batch_size,
                         "seq_len": args.calib_seq_len},
               "whitened": not args.no_whiten,
               "params_init": PARAMS_INIT})
    seconds["artifact"] = now() - t4
    print(f"      {manifest['n_tensors']} tensors, "
          f"{manifest['bytes'] / 2**20:.2f} MiB on disk, checksum "
          f"{manifest['checksum']}; serve with:\n"
          f"      python -m repro_torch.launch.serve --arch {args.arch} "
          f"--offload --artifact {args.out}")
    return {"manifest": manifest, "stacks_by_layer": stacks_by_layer,
            "plan": plan, "stats": stats, "seconds": seconds,
            "weighted_restoration_err": err, "wire_bytes": total}


if __name__ == "__main__":
    main()
