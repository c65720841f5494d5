"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``,
port of ``repro/launch/train.py``.

Runs the reduced config (or the full one with ``--full-config``) end to
end through the fault-tolerant loop: checkpointing (``--ckpt DIR``),
straggler monitor, resumption.  Everything runs on ``--device``
(default ``cuda``, which raises when there is no CUDA device; ``cpu``
runs on the CPU).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (pod-scale) config instead of the "
                         "reduced CPU config")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda | cpu); cuda raises when "
                         "there is no CUDA device")
    return ap


def main(argv: Optional[List[str]] = None):
    from ..registry import get_config
    args = build_parser().parse_args(argv)
    return run(get_config(args.arch, reduced=not args.full_config), args)


def run(cfg, args):
    """Train ``cfg`` as the flags say; returns the ``TrainResult``."""
    from ..config import TrainConfig
    from ..train import train
    dev = resolve_device(args.device)
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"on {dev}")
    tcfg = TrainConfig(total_steps=args.steps, lr=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       checkpoint_every=max(args.steps // 4, 1),
                       loss_chunk=0)
    res = train(cfg, tcfg, checkpoint_dir=args.ckpt, log_every=10,
                batch_shape=(args.batch, args.seq), device=dev)
    print(f"done; final loss {res.history[-1]['loss']:.4f}")
    return res


if __name__ == "__main__":
    main()
