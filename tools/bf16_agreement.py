#!/usr/bin/env python3
"""How far the port's kernel engine and its ``kernel_impl="ref"`` engine
drift apart in bf16, teacher-forced, on narrow versions of the served
models (the basis of ``chip_smoke.py``'s LOGIT_TOL_BF16 and
NEAR_TIE_BF16).

Runs on the CPU, where the kernel engine runs each kernel's plain
version: the same f32 arithmetic as the kernels, rounded to bf16 where
the kernel path rounds.  Both engines prefill 4 random prompts and read
the kernel engine's greedy tokens; each step prints max |dlogit| / max
|logit| per row, the router flips and how far apart (relative to the
k-th probability) the flipped experts were.  For an MoE model it then
serves without compensation (plan top_n 0) and with top-n 1, to show
what a missing compensator looks like on the same scale.

    PYTHONPATH=src python tools/bf16_agreement.py deepseek [--layers 14]
    PYTHONPATH=src python tools/bf16_agreement.py mixtral | llama
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.models.transformer import (compress_dense_params,  # noqa
                                            compress_moe_params, init_params)
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def narrow(which: str, layers: int):
    """The published config at narrow width and vocabulary, its depth,
    expert count, top-k, head dim and bits kept."""
    full = get_config({"deepseek": "deepseek-moe-16b",
                       "mixtral": "mixtral-8x7b",
                       "llama": "llama3.2-3b"}[which])
    kw = dict(vocab_size=8192, head_dim=128)
    if which == "deepseek":
        kw.update(d_model=256, num_heads=2, num_kv_heads=2, d_ff=1024,
                  moe=dataclasses.replace(
                      full.moe, d_expert=128, d_shared=128,
                      quant=dataclasses.replace(full.moe.quant,
                                                hqq_iters=5)))
    elif which == "mixtral":
        kw.update(num_layers=2, d_model=512, num_heads=4, num_kv_heads=1,
                  moe=dataclasses.replace(
                      full.moe, d_expert=1024,
                      quant=dataclasses.replace(full.moe.quant,
                                                hqq_iters=5)))
    else:
        kw.update(d_model=384, num_heads=3, num_kv_heads=1, d_ff=1024,
                  quant=dataclasses.replace(full.quant, hqq_iters=5))
    if layers:
        kw["num_layers"] = layers
    return dataclasses.replace(full, **kw)


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).tolist()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=("deepseek", "mixtral", "llama"))
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the published depth; Mixtral 2)")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    cfg = narrow(args.model, args.layers)
    t0 = time.time()
    p = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    if cfg.moe is not None:
        q, cq, stacks = compress_moe_params(p, cfg)
        n_moe = len(stacks)
    else:
        q, cq = compress_dense_params(p, cfg)
        n_moe = 0
    print(f"{cfg.name} narrow: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}; compressed in {time.time() - t0:.1f} s",
          flush=True)
    B, P, NEW = 4, 64, args.steps
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    eng = ServeEngine(cq, q, quantized=True, kernel_impl="auto",
                      device="cpu")
    ref = ServeEngine(cq, q, quantized=True, kernel_impl="ref",
                      device="cpu")
    toks = eng.generate(prompts, NEW).tokens

    def run(plan=None, steps=NEW, trace=True):
        lk, ck = eng.prefill(prompts, NEW)
        lr, cr = ref.prefill(prompts, NEW)
        out = [max(rel(lk, lr))]
        for t in range(steps):
            tk = torch.from_numpy(toks[:, t].copy())
            ok = eng.step(tk, ck, plan=plan)
            orf = ref.step(tk, cr)
            ck, cr = ok.caches, orf.caches
            r = rel(ok.logits, orf.logits)
            out.append(max(r))
            if not trace:
                continue
            flips, apart = 0, 0.0
            for layer in range(n_moe):
                for row in range(B):
                    a, b = ok.trace[layer, row], orf.trace[layer, row]
                    diff = set(a.tolist()) ^ set(b.tolist())
                    if diff:
                        flips += 1
                        pr = orf.router_probs[layer, row]
                        kth = float(torch.topk(pr, a.numel()).values[-1])
                        apart = max(apart, max(abs(float(pr[e]) - kth) / kth
                                               for e in diff))
            print(f"  step {t}: max |dlogit| / max |logit| per row "
                  f"{['%.4f' % x for x in r]}; router flips {flips} of "
                  f"{n_moe * B}, furthest {apart:.3f} of the k-th "
                  f"probability", flush=True)
        return out

    worst = run()
    print(f"kernel vs ref engine, bf16: worst {max(worst):.4f} "
          f"(prefill {worst[0]:.4f})", flush=True)
    if n_moe:
        pad = stacks[0]["w1"].pad_rank
        for name, top_n in (("no compensation", 0), ("top-n 1", 1)):
            plan = torch.tensor([[top_n, pad]] * n_moe, dtype=torch.int32)
            w = run(plan, steps=4, trace=False)
            print(f"kernel engine with {name} vs ref engine: per step "
                  f"{['%.4f' % x for x in w]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
