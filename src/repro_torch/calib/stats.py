"""Calibration stage 1: per-expert routing / activation statistics.

Port of ``repro/calib/stats.py``.  A calibration corpus (the
deterministic Zipf-Markov synthetic stream of ``data/synthetic.py``, or
any token batches) runs through the forward with two outputs enabled:
the router trace (``ExecContext.collect_trace``) and the normed MoE-FFN
inputs (``ExecContext.collect_moe_inputs``).  From those, one reduction
per MoE layer, on the device the parameters live on, gives per expert:

- ``counts``     how many (token, slot) assignments routed to it,
- ``gate_mass``  the summed normalized gate weight of those assignments,
- ``in_moment``  the diagonal second moment E[x^2] of the layer inputs
                 routed to it (whitens the w1/w3 compensators),
- ``hid_moment`` the diagonal second moment E[h^2] of its own hidden
                 activation h = act(x w1) * (x w3) (whitens w2).

Everything is accumulated in f64 on the host between batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..data.synthetic import SyntheticLM, SyntheticLMConfig
from ..models import model as lm
from ..models.layers import activation
from ..models.transformer import ExecContext, layer_specs

# bytes of the (E_chunk, T, d_expert) f32 hidden activations that one
# expert chunk of ``_layer_reduce`` may hold (two such products live at
# once)
HIDDEN_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass
class LayerCalibStats:
    """Accumulated statistics of one MoE layer (E experts)."""
    counts: np.ndarray        # (E,) f64 routed assignments
    gate_mass: np.ndarray     # (E,) f64 summed gate weight
    in_moment: np.ndarray     # (E, d) f64 sum of x^2 over routed tokens
    hid_moment: np.ndarray    # (E, fe) f64 sum of h^2 per expert
    tokens: int = 0           # calibration tokens seen

    @property
    def freq(self) -> np.ndarray:
        """(E,) routed-assignment share (sums to top_k over experts)."""
        return self.counts / max(self.tokens, 1)

    def importance(self, eps: float = 1e-3) -> np.ndarray:
        """(E,) normalized expert importance for error weighting: gate
        mass share, floored at ``eps`` so cold experts keep a stake."""
        total = max(float(self.gate_mass.sum()), 1e-12)
        w = self.gate_mass / total
        w = np.maximum(w, eps / len(w))
        return w / w.sum()

    def moment_for(self, proj: str) -> np.ndarray:
        """(E, K) mean input second moment for a projection's K axis: the
        layer input for w1/w3, the expert hidden for w2.  Experts with no
        routed calibration tokens get an all-ones moment (unwhitened)."""
        mom = self.in_moment if proj in ("w1", "w3") else self.hid_moment
        cnt = np.maximum(self.counts, 1.0)[:, None]
        mean = mom / cnt
        flat = mean.sum(axis=1) <= 0
        if flat.any():
            mean[flat] = 1.0
        return mean

    def merge(self, other: "LayerCalibStats") -> "LayerCalibStats":
        return LayerCalibStats(self.counts + other.counts,
                               self.gate_mass + other.gate_mass,
                               self.in_moment + other.in_moment,
                               self.hid_moment + other.hid_moment,
                               self.tokens + other.tokens)


def _zero_stats(e: int, d: int, fe: int) -> LayerCalibStats:
    return LayerCalibStats(np.zeros(e), np.zeros(e), np.zeros((e, d)),
                           np.zeros((e, fe)))


@torch.no_grad()
def _layer_reduce(x: torch.Tensor, topk: torch.Tensor,
                  w_router: torch.Tensor, w1: torch.Tensor,
                  w3: torch.Tensor, *, num_experts: int, act: str,
                  norm_topk: bool):
    """One MoE layer's per-expert reductions over a (T, d) input batch.

    ``topk`` is the forward's traced (T, k) router decision; gates are
    recomputed from the same router weights.  The hidden moment runs over
    chunks of experts so that the (E, T, d_expert) activations stay
    within ``HIDDEN_CHUNK_BYTES``."""
    x32 = x.float()
    probs = torch.softmax(x32 @ w_router.float(), dim=-1)
    idx = topk.long()
    gates = probs.gather(-1, idx)                              # (T, k)
    if norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(idx, num_experts).float()                   # (T, k, E)
    assign = oh.sum(dim=1)                                     # (T, E)
    counts = assign.sum(dim=0)
    gmass = (oh * gates[..., None]).sum(dim=(0, 1))
    in_mom = assign.T @ (x32 * x32)                            # (E, d)
    f = activation(act)
    t, fe = x32.shape[0], w1.shape[-1]
    step = max(1, HIDDEN_CHUNK_BYTES // max(t * fe * 4, 1))
    hid = []
    for e0 in range(0, num_experts, step):
        sl = slice(e0, min(e0 + step, num_experts))
        h = f(torch.einsum("td,edf->etf", x32, w1[sl].float())) \
            * torch.einsum("td,edf->etf", x32, w3[sl].float())
        hid.append(torch.einsum("te,etf->ef", assign[:, sl], h * h))
        del h
    return counts, gmass, in_mom, torch.cat(hid)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


@torch.no_grad()
def collect_calibration_stats(cfg: ModelConfig, params, *,
                              batches: int = 4,
                              batch_size: int = 8,
                              seq_len: int = 128,
                              seed: int = 0
                              ) -> List[LayerCalibStats]:
    """Run the calibration corpus through the forward, on the device the
    parameters live on, and return one ``LayerCalibStats`` per MoE layer
    (global layer order, the order of ``compress_moe_params``'s
    ``stacks_by_layer``).  Identical (cfg, params, seed, batches) give
    identical statistics."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE layers to calibrate")
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, batch_size=batch_size, seq_len=seq_len,
        seed=seed))
    ctx = ExecContext(mode="train", quantized=False, exact_capacity=True,
                      collect_trace=True, collect_moe_inputs=True)
    moe_layers = [lp["moe"] for lp, spec in zip(params["layers"],
                                                layer_specs(cfg))
                  if spec.ffn == "moe"]
    dev = params["embed"]["tok"].device
    e, d, fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    stats = [_zero_stats(e, d, fe) for _ in moe_layers]
    for bi in range(batches):
        toks = torch.as_tensor(data.batch(bi)["tokens"],
                               device=dev)
        out = lm.forward(params, toks, cfg, ctx)
        ntok = int(toks.numel())
        for li, mp in enumerate(moe_layers):
            counts, gmass, in_mom, hid_mom = _layer_reduce(
                out.moe_inputs[li], out.trace[li], mp["router"],
                mp["w1"], mp["w3"], num_experts=e, act=cfg.act,
                norm_topk=cfg.moe.router_norm_topk)
            stats[li] = stats[li].merge(LayerCalibStats(
                _f64(counts), _f64(gmass), _f64(in_mom), _f64(hid_mom),
                ntok))
        del out
    return stats


def stats_summary(stats: List[LayerCalibStats]) -> Dict:
    """Compact per-layer report for CLIs / manifests."""
    return {
        "layers": len(stats),
        "tokens": stats[0].tokens if stats else 0,
        "freq": [np.round(s.freq, 4).tolist() for s in stats],
        "importance": [np.round(s.importance(), 4).tolist() for s in stats],
    }
