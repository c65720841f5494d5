"""Step-function builders: train / prefill / serve (port of
``repro/launch/steps.py``).

``make_train_step`` differentiates ``lm_loss`` with autograd (in place
of ``jax.value_and_grad``) through per-layer recomputation, then runs
``adamw_update``; the prefill and serve steps run ``forward`` /
``decode_step`` against caches the caller allocates
(``models.transformer.init_caches``), which they write in place.  These
are the entry points of an encoder-decoder model (Whisper: the batch
carries ``enc_embeds``) and of M-RoPE positions (Qwen2-VL: ``mrope_pos``),
which ``ServeEngine`` does not take.  Batch leaves may be numpy arrays
or tensors; they are moved to the builder's device (default: the CUDA
device; raises if there is none).  On an expert-parallel serving mesh
(``launch.mesh.make_serve_mesh``) the prefill and serve steps run the MoE
layers over the rank's local slice of experts (the params a rank holds:
``distributed.sharding.local_expert_slice``); a train step on a mesh
waits for ROADMAP A13b (training on a mesh), and the dry run's abstract
cells for A15.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..config import ModelConfig, ParallelConfig, TrainConfig
from ..models import model as lm
from ..models.transformer import ExecContext
from ..optim.adamw import OptState, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_context(cfg: ModelConfig, mode: str, *, quantized: bool = False,
                 mesh=None, pcfg=None, remat: bool = False,
                 exact_capacity: bool = False, remat_policy: str = "full",
                 kernel_impl: Optional[str] = None,
                 collect_trace: bool = False,
                 collect_moe_inputs: bool = False) -> ExecContext:
    """The forward pass's context.  With a serving ``mesh`` (a
    ``launch.mesh.ServeMesh``) an MoE model's layers run expert-parallel:
    ``ep_mode`` is 'replicated' in step mode (decode: resident-expert
    partials + all-reduce) and 'a2a' at prefill; ``pcfg`` maps the
    logical axes (default ``ParallelConfig()``)."""
    ep_mode, moe_fn = "none", None
    if mesh is not None:
        if mode == "train":
            raise NotImplementedError(
                "a train step on a mesh is not ported yet: ROADMAP A13b "
                "(training on a mesh)")
        if cfg.moe is not None:
            from ..distributed.moe_parallel import make_moe_ep_fn
            ep_mode = "replicated" if mode == "step" else "a2a"
            moe_fn = make_moe_ep_fn(mesh, pcfg or ParallelConfig())
    return ExecContext(mode=mode, quantized=quantized, ep_mode=ep_mode,
                       moe_ep_fn=moe_fn, remat=remat,
                       exact_capacity=exact_capacity,
                       remat_policy=remat_policy, kernel_impl=kernel_impl,
                       collect_trace=collect_trace,
                       collect_moe_inputs=collect_moe_inputs)


def _to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    pcfg=None, remat_policy: str = "full", device=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient, then AdamW, whose new parameters are written into the
    state's parameter tensors in their dtype (the returned state holds
    the same tensors; JAX's builder takes ``param_dtype`` for its fresh
    ones).  Metrics are 0-d tensors: ``lm_loss``'s, ``grad_norm`` and
    ``lr``."""
    from ..train.microbatch import value_and_grad  # train/ imports this
    dev = resolve_device(device)
    ctx = make_context(cfg, "train", mesh=mesh, pcfg=pcfg, remat=True,
                       remat_policy=remat_policy)

    def loss_fn(params, batch):
        return lm.lm_loss(params, batch, cfg, ctx, z_loss=tcfg.z_loss,
                          loss_chunk=tcfg.loss_chunk)

    grad_fn = value_and_grad(loss_fn)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        (_, metrics), grads = grad_fn(state.params, _to_device(batch, dev))
        params, opt, om = adamw_update(grads, state.opt, tcfg, state.params)
        return TrainState(params, opt), {**metrics, **om}

    return train_step, ctx


def make_prefill_step(cfg: ModelConfig, *, quantized: bool = False,
                      mesh=None, pcfg=None, kernel_impl: Optional[str] = None,
                      device=None):
    """``prefill_step(params, caches, batch) -> (last logits (B, V),
    caches)``; the caches are written in place."""
    dev = resolve_device(device)
    ctx = make_context(cfg, "prefill", quantized=quantized, mesh=mesh,
                       pcfg=pcfg, kernel_impl=kernel_impl)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        batch = _to_device(batch, dev)
        out = lm.forward(params, batch["tokens"], cfg, ctx, caches=caches,
                         mrope_pos=batch.get("mrope_pos"),
                         enc_embeds=batch.get("enc_embeds"))
        return out.logits[:, -1], out.caches

    return prefill_step, ctx


def make_serve_step(cfg: ModelConfig, *, quantized: bool = False,
                    mesh=None, pcfg=None, kernel_impl: Optional[str] = None,
                    device=None):
    """``serve_step(params, caches, batch) -> (logits (B, V), caches)``
    for one new token per row; the caches are written in place."""
    dev = resolve_device(device)
    ctx = make_context(cfg, "step", quantized=quantized, mesh=mesh,
                       pcfg=pcfg, kernel_impl=kernel_impl)

    @torch.no_grad()
    def serve_step(params, caches, batch):
        batch = _to_device(batch, dev)
        out = lm.decode_step(params, batch["tokens"], caches, cfg, ctx,
                             mrope_pos=batch.get("mrope_pos"))
        return out.logits[:, 0], out.caches

    return serve_step, ctx
