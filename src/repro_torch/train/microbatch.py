"""Gradient accumulation: split the global batch into microbatches and
accumulate grads in f32 (port of ``repro/train/microbatch.py``; a Python
loop over the slices in place of ``lax.scan``) — peak activation memory
scales with the microbatch, not the global batch.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..tree import tree_leaves, tree_map


def value_and_grad(loss_fn: Callable):
    """``loss_fn(params, batch) -> (loss, metrics)``.  Returns
    ``fn(params, batch) -> ((loss, metrics), grads)``, the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``: autograd through
    detached views of the parameters (the caller's tensors are not
    marked), grads in the parameters' structure and dtypes, loss and
    metrics detached."""
    def vg(params, batch):
        views = tree_map(
            lambda t: t.detach().requires_grad_(t.is_floating_point()),
            params)
        leaves = tree_leaves(views)
        loss, metrics = loss_fn(views, batch)
        want = [t for t in leaves if t.requires_grad]
        got = torch.autograd.grad(loss, want, allow_unused=True)
        by_id = {id(t): g for t, g in zip(want, got) if g is not None}
        return ((loss.detach(),
                 {k: v.detach() if torch.is_tensor(v) else v
                  for k, v in metrics.items()}),
                tree_map(lambda t: by_id.get(id(t), torch.zeros_like(t)),
                         views))
    return vg


def microbatched_value_and_grad(loss_fn: Callable, num_micro: int):
    """The signature of ``value_and_grad(loss_fn)``, run over
    ``num_micro`` slices of every batch leaf's leading dim; grads, loss
    and metrics accumulate as f32 sums of each slice's over
    ``num_micro``."""
    grad_fn = value_and_grad(loss_fn)
    if num_micro <= 1:
        return grad_fn

    def split(x, i):
        b = x.shape[0]
        assert b % num_micro == 0, (b, num_micro)
        n = b // num_micro
        return x[i * n:(i + 1) * n]

    def vg(params, batch):
        acc = loss_acc = metrics_acc = None
        for i in range(num_micro):
            (loss, metrics), grads = grad_fn(
                params, {k: split(v, i) for k, v in batch.items()})
            if acc is None:
                acc = tree_map(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device), grads)
                loss_acc = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                metrics_acc = {k: 0.0 for k in metrics}
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.float() / num_micro)
            loss_acc = loss_acc + loss / num_micro
            metrics_acc = {k: metrics_acc[k] + v / num_micro
                           for k, v in metrics.items()}
        return (loss_acc, metrics_acc), acc
    return vg
