"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

- checkpoint/restart: atomic saves every N steps, auto-resume from the
  latest valid checkpoint (torn writes fall back one step);
- failure injection: a ``FailureInjector`` can kill the loop at a chosen
  step;
- straggler monitor: per-step wall-clock EWMA with a deadline policy
  (warn / abort);
- deterministic data: batch(step) is a pure function, so resume replays
  the exact stream (no data-loader state in the checkpoint).  The train
  step's backward adds no atomics whose order changes a sum, so on the
  card too a resumed run repeats the uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..config import ModelConfig, TrainConfig
from ..data.synthetic import SyntheticLM, SyntheticLMConfig
from ..launch.steps import TrainState, make_train_step
from ..models.transformer import init_params
from ..optim.adamw import adamw_init


class StragglerMonitor:
    """EWMA step-time tracker with a relative deadline policy."""

    def __init__(self, threshold: float = 3.0, warmup: int = 5,
                 policy: str = "warn"):
        self.threshold = threshold
        self.warmup = warmup
        self.policy = policy
        self.ewma: Optional[float] = None
        self.seen = 0
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = (self.seen > self.warmup
                and dt > self.threshold * self.ewma)
        if slow:
            self.flagged.append(step)
            if self.policy == "abort":
                raise TimeoutError(
                    f"step {step} took {dt:.3f}s > "
                    f"{self.threshold}x EWMA {self.ewma:.3f}s")
        self.ewma = 0.9 * self.ewma + 0.1 * dt
        return slow


class FailureInjector:
    """Deterministic crash injection for restart tests."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainResult:
    state: Any
    history: List[Dict[str, float]]
    resumed_from: Optional[int]
    straggler_flags: List[int]


def train(cfg: ModelConfig, tcfg: TrainConfig, *,
          data: Optional[SyntheticLM] = None,
          checkpoint_dir: Optional[str] = None,
          mesh=None, pcfg=None,
          failure: Optional[FailureInjector] = None,
          straggler: Optional[StragglerMonitor] = None,
          log_every: int = 10,
          param_dtype=torch.float32,
          batch_shape=(8, 128),
          init_fn: Optional[Callable[[int], Any]] = None,
          device=None) -> TrainResult:
    """Train from ``init_fn(tcfg.seed)`` (default: ``init_params`` from
    the seed) on ``device`` (default: the CUDA device; raises if there is
    none), resuming from ``checkpoint_dir``'s latest valid checkpoint."""
    if mesh is not None or pcfg is not None:
        raise NotImplementedError("train(mesh=, pcfg=) is not ported yet: "
                                  "ROADMAP A13b (training on a mesh)")
    dev = resolve_device(device)
    data = data or SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, batch_size=batch_shape[0],
        seq_len=batch_shape[1], seed=tcfg.seed))
    ckpt = CheckpointManager(checkpoint_dir, tcfg.keep_checkpoints) \
        if checkpoint_dir else None
    straggler = straggler or StragglerMonitor()

    step_fn, _ = make_train_step(cfg, tcfg, mesh=mesh, pcfg=pcfg,
                                 device=dev)

    # init or resume
    resumed_from = None
    start = 0
    if init_fn is not None:
        params = init_fn(tcfg.seed)
    else:
        params = init_params(cfg, tcfg.seed, param_dtype, dev)
    state = TrainState(params, adamw_init(params))
    if ckpt and ckpt.latest_step() is not None:
        state, man = ckpt.restore(state)
        start = man["step"]
        resumed_from = start

    history: List[Dict[str, float]] = []
    for step in range(start, tcfg.total_steps):
        if failure:
            failure.maybe_fail(step)
        t0 = time.time()
        state, metrics = step_fn(state, data.batch(step))
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        straggler.observe(step, dt)
        metrics.update(step=step, dt=dt)
        history.append(metrics)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms",
                  flush=True)
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(step + 1, state, extra={"loss": metrics["loss"]})
    if ckpt:
        ckpt.save(tcfg.total_steps, state,
                  extra={"loss": history[-1]["loss"] if history else None})
    return TrainResult(state, history, resumed_from, straggler.flagged)
