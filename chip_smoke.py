#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # on a machine with an H100

Phases:
  1. preflight  the card's name and power limit; build the CUDA kernels
                from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
                one nvcc per source, in parallel
  2. kernels    hold each kernel against its plain PyTorch version on the
                card, at the shapes of the Mixtral-8x7B and Llama-3.2-3B
                serving paths
  3. slice      Mixtral-8x7B at its published widths, depth cut to 2
                layers, random f32 weights from a seeded generator:
                compress on the card, ``ServeEngine.generate`` through
                the kernels with each decode step replayed from a CUDA
                graph (captured in a warm-up generate of the timed
                bucket), held to the eager decode loop on the same
                prompts; both loops' decode profiles and one prefill's;
                and its teacher-forced logits and router choices against
                the same engine with impl='ref'
  4. timing     each MoE-path kernel, its plain version and (where one
                exists) a PyTorch library call computing the same
                function, beside its bound; the fused kernel at prefill
                on both of its paths (CUDA cores, tensor cores), split
                into its rank-space pre-pass and main kernel, beside both
                its bounds, and both paths at smaller C (the crossover
                FUSED_MMA_MIN_C rests on); flash-decode at the slice's
                S 512 and at long context (S 4096, 32768) for each cache
                type, beside its byte bound, its rate and SDPA
  5. dense      Llama-3.2-3B at its published config (28 layers, dense
                FFNs compressed to E = 1 stacks): the same as phase 3
                (graph against eager, the profiles, teacher-forced),
                then the dense-path kernels timed as in phase 4, with
                quant_matmul's prefill (tensor-core path) beside both its
                bounds and w1/w2 on both of its paths at small M

It prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line; without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FP32 (CUDA-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# and bf16 on the tensor cores (dense, f32 accumulate)
BF16_TC_FLOPS = 989e12

# kernel vs plain version, both f32 on the card: the sums run in another
# order (split over 8 warps and 64-row blocks, the dequant factored per
# block) over K <= 14336 terms, so |diff| <= 1e-3 + 1e-4 |ref| (the JAX
# package's fused-kernel parity tolerance)
FUSED_TOL = dict(atol=1e-3, rtol=1e-4)
# flash-decode: f32 online softmax in another order than softmax()
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
# served logits, kernel engine vs impl='ref' engine, f32 through 2
# (Mixtral) or 28 (Llama) layers: max |diff| <= LOGIT_TOL * max |ref logit|
LOGIT_TOL = 1e-3
# router choices may differ only where the two probabilities compared
# are this close (a near-tie flipped by f32 rounding)
NEAR_TIE = 1e-3
# log-probs of the graph-replayed decode loop against the eager loop: the
# same kernels on the same inputs, so |diff| <= 1e-5 (tokens and router
# trace must be identical)
GRAPH_LP_TOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def allclose_report(name, got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    mx = float(err.max()) if err.numel() else 0.0
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements off, max |diff| {mx:.3e} "
             f"(atol {atol}, rtol {rtol})")
    return mx


def time_ms(fn, iters: int, flush: torch.Tensor) -> dict:
    """Time of one call of ``fn`` on the card, with the L2 cache
    overwritten before each call (decode reads its weights cold).

    ``device``: the median over calls of the time between two CUDA events
    around the call, taken while the card runs only this work: a spin
    kernel (``torch.cuda._sleep``) holds the stream until the host has
    queued the flush, the events and all of the call's kernels, so the
    events see the kernels back to back and none of the host's launch time.
    ``wall``: the same events without the spin, which also count the
    host's time to launch the call's kernels when the card waits on it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.bitwise_not_()
    fn()
    enqueue_s = time.perf_counter() - t0          # host time to queue it
    torch.cuda.synchronize()
    # cycles of the spin: twice the queueing time plus 0.5 ms at 2 GHz,
    # above the H100's top clock, so the spin never ends early
    spin = int((2 * enqueue_s + 5e-4) * 2e9)
    dev, walls = [], []
    for held in (True, False):
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(spin)
            flush.bitwise_not_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            (dev if held else walls).append(a.elapsed_time(b))
    return {"device": float(np.median(dev)), "wall": float(np.median(walls))}


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def random_stack_inputs(gen, dev, E, C, K, N, R, bits, gated, rank_mode,
                        hetero, with_rows=False, rows=None):
    """Random kernel arguments of one fused-expert case; ``with_rows``
    gives each expert an occupied-slot count (one idle expert, one full),
    or ``rows`` (a list, one count per expert) these counts, and zeroes
    the slots past it, as dispatch leaves them."""
    from repro_torch.core.quantize import PLANES

    def rint(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dt)

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    G = 64
    planes = tuple(rint(0, 256, (E, K * p // 8, N), torch.uint8)
                   for p, _ in PLANES[bits])
    scale = rnd(E, K // G, N) * 0.02 + 1e-3
    zero = rnd(E, K // G, N) * ((1 << bits) - 1)
    u = rint(-127, 128, (E, K, R), torch.int8)
    v = rint(-127, 128, (E, R, N), torch.int8)
    u_scale = rnd(E, 1, R) * 1e-3
    v_scale = rnd(E, R, 1) * 1e-3
    xe = torch.randn((E, C, K), generator=gen, device=dev)
    me = (rnd(E, C) < 0.5).float()
    ge = rnd(E, C) if gated else None
    ranks = torch.tensor([R if e % 3 == 0 else (R // 2 if e % 3 == 1 else 0)
                          for e in range(E)], dtype=torch.int32, device=dev)
    cap = {"zero": 0, "half": R // 2, "full": None}[rank_mode]
    cap = None if cap is None else torch.tensor([cap], dtype=torch.int32,
                                                device=dev)
    eb = [bits] * E
    if hetero:
        eb = [bits if e % 2 else max(b for b in (1, 2, 3, 4) if b < bits)
              for e in range(E)]
    eb = torch.tensor(eb, dtype=torch.int32, device=dev)
    if rows is not None:
        rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    elif with_rows:
        rows = rint(0, C + 1, (E,), torch.int32)
        rows[0], rows[1] = 0, C
    if rows is not None:
        live = (torch.arange(C, device=dev)[None, :] < rows[:, None]).float()
        xe, me = xe * live[:, :, None], me * live
    return (xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge, cap,
            eb, ranks, rows)


def qmm_case_inputs(gen, dev, M, K, N, R, bits, mask_mode="ones", cap=None):
    """Random arguments of one quant_matmul case: planes (K*p/8, N) u8,
    g64 scale/zero, int8 U/V with their scales, a mask and a rank cap."""
    from repro_torch.core.quantize import PLANES

    def rint(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dt)

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    planes = tuple(rint(0, 256, (K * p // 8, N), torch.uint8)
                   for p, _ in PLANES[bits])
    scale = rnd(K // 64, N) * 0.02 + 1e-3
    zero = rnd(K // 64, N) * ((1 << bits) - 1)
    x = torch.randn((M, K), generator=gen, device=dev)
    u = rint(-127, 128, (K, R), torch.int8)
    v = rint(-127, 128, (R, N), torch.int8)
    us = rnd(1, R) * 1e-3
    vs = rnd(R, 1) * 1e-3
    mask = {"ones": torch.ones((M,), device=dev),
            "half": (rnd(M) < 0.5).float(),
            "zeros": torch.zeros((M,), device=dev)}[mask_mode]
    capt = None if cap is None else torch.tensor([cap], dtype=torch.int32,
                                                 device=dev)
    return (x, planes, scale, zero, u, us, v, vs, mask, capt)


def qmm_kernel_cases(dev, gen):
    """Kernel 3 against its plain version: the three Llama-3.2-3B
    projections at decode (M 4, split-K path) and prefill (M 1024,
    tensor-core path), 2 bits, rank 32, every token compensated; then
    other widths, ragged M on both paths, a mask with zeros, a rank cap
    below R, and no compensation at all."""
    from repro_torch.kernels import quant_matmul as qm
    worst = 0.0
    cases = [(proj, M, K, N, 2, "ones", None)
             for proj, K, N in (("w1", 3072, 8192), ("w3", 3072, 8192),
                                ("w2", 8192, 3072))
             for M in (4, 1024)]
    cases += [("w1", 4, 3072, 8192, b, "half", 20) for b in (3, 4, 8)]
    cases += [("w2", 33, 8192, 3072, 3, "half", 20),
              ("w2", 4, 8192, 3072, 2, "zeros", None),
              ("w1", 33, 3072, 8192, 4, "ones", 0),
              ("w1", 1, 3072, 8192, 2, None, None)]
    # the tensor-core path (M >= MMA_MIN_M): ragged M, 3 and 8 bits
    cases += [("w1", 129, 3072, 8192, 3, "half", 20),
              ("w2", 129, 8192, 3072, 8, "half", 20),
              ("w2", 1000, 8192, 3072, 3, "half", 20),
              ("w1", 1000, 3072, 8192, 8, "half", 20)]
    for proj, M, K, N, bits, mask_mode, cap in cases:
        args = qmm_case_inputs(gen, dev, M, K, N, 32, bits,
                               mask_mode or "ones", cap)
        if mask_mode is None:           # quant_matmul: no compensation
            args = args[:4]
        got = qm.quant_matmul(*args, bits=bits, group_size=64,
                              require_kernel=True)
        ref = qm.quant_matmul_plain(*args, bits=bits, group_size=64)
        name = (f"quant_matmul {proj} M={M} K={K} N={N} bits={bits} R=32 "
                f"mask={mask_mode} cap={cap}")
        mx = allclose_report(name, got, ref, **FUSED_TOL)
        worst = max(worst, mx)
        log(f"  ok  {name}  max|diff| {mx:.3e}")
        del args, got, ref
    return worst


def kernel_phase(dev):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(1234)
    E = 8
    shapes = [(4096, 14336), (14336, 4096)]
    errs = {"fused_expert_matmul": 0.0, "flash_decode_attention": 0.0,
            "quant_matmul": 0.0}
    case = 0
    for K, N in shapes:
        for bits in (2, 3, 4):
            for C in (1, 4, 1024):
                rank_mode = ("zero", "half", "full")[case % 3]
                args = random_stack_inputs(
                    gen, dev, E, C, K, N, 256, bits,
                    gated=case % 2 == 0, rank_mode=rank_mode,
                    hetero=bits > 2 and case % 2 == 1,
                    with_rows=case % 4 >= 2)
                case += 1
                got = qm.fused_expert_matmul(*args, bits=bits, group_size=64,
                                             require_kernel=True)
                ref = qm.fused_expert_matmul_plain(*args, bits=bits,
                                                   group_size=64)
                name = (f"fused K={K} N={N} bits={bits} C={C} "
                        f"cap={rank_mode} gated={args[9] is not None} "
                        f"expert_bits={args[11].tolist()} rows="
                        f"{None if args[13] is None else args[13].tolist()}")
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                errs["fused_expert_matmul"] = max(
                    errs["fused_expert_matmul"], mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
                del args, got, ref
    # both main-kernel paths forced at any C: ragged C (not a multiple of
    # the tensor-core tile's 64 tokens), 8 bits, a 3-bit container holding
    # 2-bit experts (plane 1 masked), rows at a tile's edges (64, 65).  The
    # plain version runs in f64 here: in f32 its own rounding at 8 bits
    # over K 14336 reached 3.5e-3 (5 elements over FUSED_TOL), while both
    # kernels stayed within 4.7e-4 of f64 on the H100 (PERF.md)
    for K, N in shapes:
        for bits, C, hetero in ((8, 1000, False),
                                (3, qm.FUSED_MMA_MIN_C + 2, True),
                                (2, 200, False)):
            rows = [0, C, 64, 65, 1, 63, C // 2, C - 1]
            args = random_stack_inputs(
                gen, dev, E, C, K, N, 256, bits, gated=bits != 2,
                rank_mode=("half", "full", "zero")[case % 3],
                hetero=hetero, rows=rows)
            case += 1
            ref = qm.fused_expert_matmul_plain(args[0].double(), *args[1:],
                                               bits=bits, group_size=64)
            for path in ("simt", "mma"):
                got = qm._launch_fused(path, *args, bits=bits, group_size=64)
                name = (f"fused path={path} K={K} N={N} bits={bits} C={C} "
                        f"gated={args[9] is not None} expert_bits="
                        f"{args[11].tolist()} rows={rows}")
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                errs["fused_expert_matmul"] = max(
                    errs["fused_expert_matmul"], mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref
    # per-channel groups (group_size = K) on one small case
    K, N = shapes[0]
    args = list(random_stack_inputs(gen, dev, E, 4, K, N, 32, 2, True,
                                    "full", False))
    args[2], args[3] = args[2][:, :1].contiguous(), args[3][:, :1].contiguous()
    got = qm.fused_expert_matmul(*args, bits=2, group_size=K,
                                 require_kernel=True)
    ref = qm.fused_expert_matmul_plain(*args, bits=2, group_size=K)
    mx = allclose_report("fused per-channel", got, ref, **FUSED_TOL)
    errs["fused_expert_matmul"] = max(errs["fused_expert_matmul"], mx)
    log(f"  ok  fused per-channel group K={K} N={N}  max|diff| {mx:.3e}")

    errs["quant_matmul"] = qmm_kernel_cases(dev, gen)

    # flash-decode: (B, H, KVH, hd, S, filled, kinds, windows); filled
    # "ring" is a wrapped ring cache, every slot written, positions out of
    # order.  The slices' shapes first (Mixtral G 4, Llama G 3 with a row
    # of no valid slot), then batch 1, 160 rows (a cluster of one), long
    # S, rings with a window, hd 64 and 256, G 1 and G 8
    flash_cases = [(4, 32, 8, 128, 512, filled, ("f32", "bf16", "int8"),
                    windows) for filled, windows in ((288, (None, 128)),
                                                     (10, (None,)))]
    flash_cases += [(4, 24, 8, 128, 512, filled, ("f32", "int8"), (None,))
                    for filled in (288, 0)]
    flash_cases += [(1, 32, 8, 128, 512, 288, ("f32", "int8"), (None,)),
                    (20, 32, 8, 128, 512, 300, ("f32",), (None,)),
                    (4, 32, 8, 128, 32768, 32768, ("f32", "bf16", "int8"),
                     (None,)),
                    (4, 32, 8, 128, 4096, "ring", ("f32", "bf16", "int8"),
                     (None, 1000)),
                    (4, 16, 4, 64, 1000, 700, ("f32", "bf16"), (None, 300)),
                    (2, 16, 8, 256, 2048, "ring", ("f32", "int8"), (700,)),
                    (4, 8, 8, 128, 1003, 1003, ("f32",), (None,)),
                    (4, 64, 8, 128, 1003, 900, ("bf16",), (None,))]
    for B, H, KVH, hd, S, filled, kinds, windows in flash_cases:
        for kind in kinds:
            ring = filled == "ring"
            args = flash_inputs(gen, dev, B, H, KVH, hd, S,
                                S if ring else filled, kind, ring)
            spw = fd.slots_per_warp(hd, args[1].element_size())
            cl = fd.launch_geometry(B * KVH, S, spw, fd.cluster_capacity(
                dev, fd._KV_KIND[args[1].dtype], hd, H // KVH))
            for window in windows:
                got = fd.flash_decode_attention(*args, window=window,
                                                require_kernel=True)
                ref = fd.flash_decode_attention_plain(*args, window=window)
                name = (f"flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} "
                        f"kv={kind} window={window} filled={filled} "
                        f"cluster={cl}")
                mx = allclose_report(name, got, ref, **DECODE_TOL)
                errs["flash_decode_attention"] = max(
                    errs["flash_decode_attention"], mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref
            torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 3: the serving slice
# ---------------------------------------------------------------------------

def slice_config():
    import dataclasses
    from repro_torch.registry import get_config
    full = get_config("mixtral-8x7b")
    cut = dataclasses.replace(full, num_layers=2)
    log(f"  config {cut.name}: d_model {cut.d_model}, heads {cut.num_heads}"
        f"/{cut.num_kv_heads} kv, head_dim {cut.head_dim}, experts "
        f"{cut.moe.num_experts} top-{cut.moe.top_k}, d_expert "
        f"{cut.moe.d_expert}, vocab {cut.vocab_size}, bits "
        f"{cut.moe.quant.bits}, rank_budget {cut.moe.quant.rank_budget}, "
        f"top_n {cut.moe.quant.top_n_restore}")
    log(f"  depth cut: {full.num_layers} -> {cut.num_layers} layers "
        f"(widths as published)")
    return cut


def near_tie(probs_row: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Two top-k id sets chosen from (nearly) the same probabilities
    differ only by experts whose probabilities are within NEAR_TIE of
    the k-th largest."""
    k = a.numel()
    kth = torch.topk(probs_row, k).values[-1]
    diff = set(a.tolist()) ^ set(b.tolist())
    return all(abs(float(probs_row[e] - kth)) <= NEAR_TIE for e in diff)


def teacher_forced(eng, ref, prompts, toks, n_moe: int) -> None:
    """Both engines prefill the prompts and then read the kernel engine's
    tokens step by step; their logits must agree within LOGIT_TOL of the
    reference's largest, and their router choices (MoE layers) outside
    near-ties.  A row whose router flipped at a near-tie is not compared
    after that step."""
    dev = eng.device
    B, NEW = toks.shape
    lk, ck = eng.prefill(prompts, NEW)
    lr, cr = ref.prefill(prompts, NEW)
    row_ok = np.ones(B, bool)
    worst = 0.0
    flips = 0

    def compare(step, a, b):
        nonlocal worst
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"step {step}: non-finite kernel-engine logits")
        for r in np.nonzero(row_ok)[0]:
            scale = float(b[r].abs().max())
            d = float((a[r] - b[r]).abs().max())
            worst = max(worst, d / max(scale, 1e-30))
            if d > LOGIT_TOL * scale:
                fail(f"step {step} row {r}: max |dlogit| {d:.3e} vs "
                     f"max |logit| {scale:.3e}")

    compare("prefill", lk, lr)
    ref_tokens = torch.as_tensor(toks, device=dev)
    for t in range(NEW):
        ok = eng.step(ref_tokens[:, t], ck)
        orf = ref.step(ref_tokens[:, t], cr)
        ck, cr = ok.caches, orf.caches
        for layer in range(n_moe):
            for r in range(B):
                a, b = ok.trace[layer, r], orf.trace[layer, r]
                if row_ok[r] and set(a.tolist()) != set(b.tolist()):
                    if not near_tie(orf.router_probs[layer, r], a, b):
                        fail(f"step {t} layer {layer} row {r}: router "
                             f"top-k {a.tolist()} vs {b.tolist()}")
                    flips += 1
                    row_ok[r] = False
        compare(t, ok.logits, orf.logits)
        if not row_ok.any():
            fail("every row hit a router near-tie; nothing left to compare")
    log(f"  teacher-forced vs impl='ref': max |dlogit| / max |logit| = "
        f"{worst:.3e} (limit {LOGIT_TOL}); router near-tie flips {flips}; "
        f"rows compared to the end {int(row_ok.sum())}/{B}")


def check_generation(res, B, NEW, vocab) -> None:
    toks = res.tokens
    if toks.shape != (B, NEW) or not np.all((toks >= 0) & (toks < vocab)):
        fail(f"generated tokens malformed: shape {toks.shape}")
    if not np.all(np.isfinite(res.logprobs)):
        fail("non-finite log-probs")


def slice_phase(dev):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params)
    from repro_torch.serve.engine import ServeEngine
    cfg = slice_config()
    B, P, NEW = 4, 256, 32
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, cfg_q, stacks = compress_moe_params(params, cfg)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    del params
    s = stacks[0]["w1"]
    log(f"  init {t_init:.2f} s; compression {t_comp:.2f} s "
        f"({len(stacks)} MoE layers x 3 stacks; layer-0 w1 ranks "
        f"{list(s.ranks)}, pad_rank {s.pad_rank})")

    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    sv = serve_slice(dev, cfg_q, qparams, prompts, NEW, {
        "fused_expert_matmul": qm.launches,
        "flash_decode_attention": fd.launches,
        "quant_matmul": qm.qmm_launches,
        "fused_mma": qm.fused_mma_launches})
    eng, res = sv["engine"], sv["graph"]
    launches = sv["launches"]
    mma_launches = launches.pop("fused_mma")
    sv["eager_launches"].pop("fused_mma")
    log(f"  fused_expert_matmul launches on the tensor-core path "
        f"{mma_launches} (C >= FUSED_MMA_MIN_C {qm.FUSED_MMA_MIN_C}; "
        f"prefill C = B*P = {B * P}), on the CUDA cores "
        f"{launches['fused_expert_matmul'] - mma_launches}")
    if mma_launches <= 0:
        fail("prefill never took the fused kernel's tensor-core path")
    if min(launches["fused_expert_matmul"],
           launches["flash_decode_attention"]) <= 0:
        fail(f"a kernel of the MoE path was never launched: {launches}")
    toks = res.tokens
    check_generation(res, B, NEW, cfg.vocab_size)
    n_moe = len(stacks)
    if res.router_trace.shape != (NEW, n_moe, B, cfg.moe.top_k):
        fail(f"router trace shape {res.router_trace.shape}")

    ref = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="ref",
                      device=dev)
    teacher_forced(eng, ref, prompts, toks, n_moe)
    return {"launches": launches, "eager_launches": sv["eager_launches"],
            "stacks": stacks, "cfg": cfg_q,
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW,
            "mma_launches": mma_launches}


def serve_slice(dev, cfg_q, qparams, prompts, NEW, counters) -> dict:
    """A slice's main path: ``ServeEngine.generate`` with the decode graph,
    first a warm-up generate in the timed bucket (its 256-token prompts,
    2 new tokens: cache 512, where the one capture happens), then the
    timed one.  ``counters`` (name -> the wrappers' launch counters) are
    set to 0 before the warm-up and read after the timed run: a wrapper
    counts where Python launches its kernel, which is in prefill, in the
    eager warm-up step and at capture, never in a replay.  Then the eager
    loop (``decode_graph=False``) on the same prompts, its counts read
    alike: tokens and router trace must equal the graph's, log-probs
    within GRAPH_LP_TOL.  Both loops' decode profiles, then one prefill's;
    the eager engine is freed before returning."""
    from repro_torch.serve.engine import ServeEngine
    B, P = prompts.shape
    eng = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="auto",
                      device=dev)
    for c in counters.values():
        c.reset()
    warm = eng.generate(prompts, max_new=2)
    log(f"  decode graph capture: {warm.capture_s:.3f} s (eager warm-up "
        f"step, then capture of one decode step, in the warm-up generate "
        f"of the timed bucket; graphs {eng.num_graphs}: "
        f"{sorted(eng.graphs)})")
    res = eng.generate(prompts, max_new=NEW, seed=0)
    launches = {n: c.n for n, c in counters.items()}
    if res.capture_s or eng.num_graphs != 1:
        fail(f"the timed generate captured again: {eng.num_graphs} graphs")
    log(f"  generate (graph): {B} prompts x {P} tokens, {NEW} new tokens, "
        f"temperature 0: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{res.decode_s * 1e3:.2f} ms = {res.decode_tokens_per_s:.2f} tok/s"
        f"; wrapper launches over the warm-up and timed generates (a "
        f"replay launches no wrapper) {launches}")
    for c in counters.values():
        c.reset()
    eager = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="auto",
                        device=dev, decode_graph=False)
    eres = eager.generate(prompts, max_new=NEW, seed=0)
    eager_launches = {n: c.n for n, c in counters.items()}
    log(f"  generate (eager loop): decode {eres.decode_s * 1e3:.2f} ms = "
        f"{eres.decode_tokens_per_s:.2f} tok/s; wrapper launches (prefill "
        f"+ {NEW} steps) {eager_launches}")
    if not np.array_equal(res.tokens, eres.tokens):
        fail("graph and eager decode gave different tokens")
    if (res.router_trace is None) != (eres.router_trace is None) or (
            res.router_trace is not None
            and not np.array_equal(res.router_trace, eres.router_trace)):
        fail("graph and eager decode gave different router traces")
    lp_diff = float(np.abs(res.logprobs - eres.logprobs).max())
    if not lp_diff <= GRAPH_LP_TOL:
        fail(f"graph vs eager log-probs differ by {lp_diff:.3e} "
             f"(limit {GRAPH_LP_TOL})")
    log(f"  graph vs eager: tokens and router trace identical, max "
        f"|dlogprob| {lp_diff:.3e} (limit {GRAPH_LP_TOL})")
    pg = profile_decode(eng, prompts, res.decode_s / NEW)
    pe = profile_decode(eager, prompts, eres.decode_s / NEW)
    for name, r, p in (("graph", res, pg), ("eager", eres, pe)):
        log(f"  decode {name}: {r.decode_tokens_per_s:.2f} tok/s, host "
            f"{p['host_ms']:.3f} ms/step, device busy {p['busy_ms']:.3f} "
            f"ms/step, idle share {p['idle']:.3f}, launches/step "
            f"{p['launches']}")
    del eager
    torch.cuda.empty_cache()
    profile_prefill(eng, prompts, NEW, res.prefill_s)
    if eng.num_graphs != 1:
        fail(f"{eng.num_graphs} graphs for one bucket")
    return {"engine": eng, "graph": res, "eager": eres,
            "launches": launches, "eager_launches": eager_launches}


# ---------------------------------------------------------------------------
# phase 4: timing at decode and prefill shapes
# ---------------------------------------------------------------------------

def fused_bytes_ops(xe, stack, me, ge, rows):
    """Least bytes and operations of one fused projection on these
    inputs: the weights of the experts that hold tokens, the occupied
    token rows, the factor rows the mask and the true ranks select, each
    read once; the output written once."""
    E, C, K = xe.shape
    N = stack.scale.shape[-1]
    occ = rows.tolist()
    any_me = (me != 0).any(dim=1).tolist()
    per_expert_w = (sum(p[0].numel() for p in stack.planes)
                    + 4 * (stack.scale[0].numel() + stack.zero[0].numel()))
    nb = 4 * E * C * N + 4 * me.numel() + (0 if ge is None else 4 * ge.numel())
    ops = 0
    for e in range(E):
        if occ[e] == 0:
            continue
        nb += per_expert_w + 4 * occ[e] * K
        ops += 2 * occ[e] * K * N
        r = min(stack.pad_rank, stack.ranks[e])
        if any_me[e] and r > 0:
            nb += r * (K + N) + 8 * r
            ops += 2 * occ[e] * r * (K + N)
    return nb, ops


def bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tc_bound(nbytes, ops):
    """Least time of a quantized matmul on the tensor-core path: its
    bytes, or two bf16 products (x_hi and x_lo) of each of its operations
    at the tensor cores' dense bf16 rate, whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = 2 * ops / BF16_TC_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dispatch_like(gen, dev, E, T, K, top_k, top_n):
    """(E, C=T, K) expert buffers as ``moe.dispatch_tokens`` fills them:
    T tokens each routed to ``top_k`` distinct random experts, slots taken
    in order from 0, the first ``top_n`` choices compensated."""
    xe = torch.zeros((E, T, K), device=dev)
    me = torch.zeros((E, T), device=dev)
    ge = torch.zeros((E, T), device=dev)
    fill = [0] * E
    choice = torch.rand((T, E), generator=gen, device=dev).argsort(dim=1)
    for t, experts in enumerate(choice[:, :top_k].tolist()):
        for j, e in enumerate(experts):
            xe[e, fill[e]] = torch.randn((K,), generator=gen, device=dev)
            me[e, fill[e]] = float(j < top_n)
            ge[e, fill[e]] = 1.0 / top_k
            fill[e] += 1
    return xe, me, ge, torch.tensor(fill, dtype=torch.int32, device=dev)


def _fmt(t: dict) -> str:
    return (f"{t['device']:.4f} ms on the device ({t['wall']:.4f} ms with "
            f"the host's launches)")


def _ms(name: str, t: dict) -> float:
    """The device time of the ``kernels`` line.  No time, or more device
    time than the call takes with the host's launches, is a failed
    measurement."""
    if not t["device"] > 0:
        fail(f"{name}: no device time measured")
    if t["device"] > 1.5 * t["wall"]:
        fail(f"{name}: device time {t['device']:.4f} ms exceeds the "
             f"{t['wall']:.4f} ms between unheld events")
    return t["device"]


def flash_inputs(gen, dev, B, H, KVH, hd, S, filled, kind="f32",
                 ring=False):
    """Random flash-decode arguments (q, k, v, kv_pos, cur, k_scale,
    v_scale): q pre-scaled by 1/sqrt(hd), a (B, S, KVH, hd) cache of
    ``kind`` (f32, bf16, or int8 with bf16 scales) whose slots 0..filled-1
    hold positions 0..filled-1 and the rest are empty (-1).  ``ring``: a
    ring cache that has wrapped, every slot written and its positions out
    of order (slot s holds the newest position p <= cur with p % S == s,
    cur = S + S // 3)."""
    q = torch.randn((B, H, hd), generator=gen, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    c = S + S // 3 if ring else max(filled, 1) - 1
    pos = c - (c - ar) % S if ring else torch.where(ar < filled, ar, -1)
    pos = pos[None].repeat(B, 1).contiguous()
    cur = torch.full((B,), c, dtype=torch.int32, device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kind == "int8":
        from repro_torch.models.kvcache import _kv_quant
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    return q, k, v, pos, cur, ks, vs


def flash_bytes_ops(q, k, pos, cur, ks, window=None):
    """Least bytes and operations of one flash-decode call on these inputs:
    the K and V rows (and int8 scales) of the valid slots, the positions,
    cur and q read once, the output written once; per valid slot and query
    head, hd multiply-adds for the score and hd for the value sum."""
    B, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window:
        valid &= pos > cur[:, None] - window
    n = int(valid.sum())
    row = hd * k.element_size() + (0 if ks is None else 2)
    nb = 2 * n * KVH * row + 4 * B * S + 4 * B + 8 * B * H * hd
    return nb, 4 * n * H * hd


def sdpa_call(q, k, v, pos, cur, ks):
    """The yardstick: one ``scaled_dot_product_attention`` call (GQA, bool
    mask) computing the same function, in the cache's float type; None for
    an int8 cache, which no single PyTorch call reads."""
    import torch.nn.functional as F
    if ks is not None:
        return None
    qs = q[:, :, None, :].to(k.dtype)
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qs, kT, vT, attn_mask=mask, scale=1.0, enable_gqa=True)


def kernels_by_name(fn, flush, calls: int = 100) -> dict:
    """{kernel name: (mean device ms of one launch, launches seen)} over
    ``calls`` calls of ``fn`` under the profiler, L2 overwritten before
    each (the overwrite's own kernel left out).  The profiler may miss an
    event now and then, so the count is reported, not assumed."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            flush.bitwise_not_()
            fn()
    by = {}
    for name, ms in profiled(run)[0]:
        if "bitwise_not" not in name:
            tot, cnt = by.get(name, (0.0, 0))
            by[name] = (tot + ms, cnt + 1)
    return {n: (ms / cnt, cnt) for n, (ms, cnt) in by.items()}


def flash_slice_timing(dev, gen, flush, sl) -> dict:
    """Flash-decode at a slice's decode shape (its cache bucket, the
    prompt and new tokens valid, f32) beside its plain version, SDPA and
    its bound; the ``kernels`` line's entry."""
    from repro_torch.kernels import decode_attention as fd
    cfg, B = sl["cfg"], sl["B"]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    filled = sl["P"] + sl["NEW"]
    S = 1 << filled.bit_length()
    args = flash_inputs(gen, dev, B, H, KVH, hd, S, filled)
    q, k, v, pos, cur, _, _ = args
    kt = time_ms(lambda: fd.flash_decode_attention(
        *args, require_kernel=True), 20, flush)
    pt = time_ms(lambda: fd.flash_decode_attention_plain(*args), 20, flush)
    sd = sdpa_call(q, k, v, pos, cur, None)
    lt = time_ms(sd, 20, flush)
    got = fd.flash_decode_attention(*args, require_kernel=True)
    allclose_report("flash_decode vs SDPA", got, sd()[:, :, 0], atol=1e-4,
                    rtol=1e-4)
    bms, by = bound(*flash_bytes_ops(q, k, pos, cur, None))
    log(f"  flash_decode B={B} H={H} KVH={KVH} (G={H // KVH}) hd={hd} S={S} "
        f"valid={filled} f32: kernel {_fmt(kt)}; plain {_fmt(pt)}; SDPA "
        f"{_fmt(lt)}; bound {bms:.4f} ms ({by})")
    return dict(ms=_ms("flash-decode kernel", kt),
                plain_ms=_ms("flash-decode plain", pt), bound_ms=bms,
                bound_by=by, library_ms=_ms("SDPA", lt))


def flash_long_timing(dev, gen, flush) -> dict:
    """Flash-decode from the slice's length to long context, every slot
    valid beyond the slice's S 512 (288 valid): Mixtral's shape (B 4, H 32,
    KVH 8, hd 128) for each cache type at S 512, 4096 and 32768, and
    Llama-3.2-3B's (H 24) at S 32768, f32; each beside its bound, its
    achieved rate and SDPA's time; the kernels of one call at S 512 by
    name.  Returns the Mixtral f32 S 32768 row."""
    from repro_torch.kernels import decode_attention as fd
    cases = [(32, kind, S, filled) for kind in ("f32", "bf16", "int8")
             for S, filled in ((512, 288), (4096, 4096), (32768, 32768))]
    cases.append((24, "f32", 32768, 32768))
    out = {}
    for H, kind, S, filled in cases:
        args = flash_inputs(gen, dev, 4, H, 8, 128, S, filled, kind)
        q, k, v, pos, cur, ks, vs = args
        kt = time_ms(lambda: fd.flash_decode_attention(
            *args, require_kernel=True), 10, flush)
        sd = sdpa_call(q, k, v, pos, cur, ks)
        lt = None if sd is None else time_ms(sd, 10, flush)
        nb, ops = flash_bytes_ops(q, k, pos, cur, ks)
        bms, by = bound(nb, ops)
        ms = _ms(f"flash_decode long {kind} S={S}", kt)
        log(f"  flash_decode long B=4 H={H} KVH=8 hd=128 S={S} valid="
            f"{filled} kv={kind}: kernel {_fmt(kt)}, {nb / ms / 1e6:.1f} "
            f"GB/s ({100 * bms / ms:.1f}% of the bound); bound {bms:.4f} ms "
            f"({by}; {nb / 1e6:.2f} MB); SDPA "
            f"{'none (int8)' if lt is None else _fmt(lt)}")
        if S == 512:
            parts = kernels_by_name(lambda: fd.flash_decode_attention(
                *args, require_kernel=True), flush)
            log(f"  flash_decode S=512 kv={kind}, by kernel over 100 calls "
                f"(profiler): " + "; ".join(
                    f"{n[:70]} {c} launches, {t:.4f} ms each"
                    for n, (t, c) in sorted(parts.items())))
        if H == 32 and kind == "f32" and S == 32768:
            out = dict(long_ms=ms, long_bound_ms=bms,
                       long_library_ms=_ms("SDPA long", lt))
        del args, q, k, v, pos, cur, ks, vs
        torch.cuda.empty_cache()
    return out


def fused_crossover(dev, gen, st, cfg, flush, proj):
    """One fused projection on dispatch-like inputs (C = T tokens, top-k of
    E experts) on both main-kernel paths: {T: {path: device ms}}, the
    timings the path threshold FUSED_MMA_MIN_C rests on."""
    from repro_torch.kernels import quant_matmul as qm
    E, K = st.planes[0].shape[0], st.shape[1]
    kw = dict(bits=st.bits, group_size=st.group_size)
    eb, ranks = st.meta_tensors()
    out = {}
    for T in (16, 32, 64, 96, 128, 256, 1024):
        xe, me, ge, rows = dispatch_like(gen, dev, E, T, K, cfg.moe.top_k,
                                         cfg.moe.quant.top_n_restore)
        args = (xe, st.planes, st.scale, st.zero, st.u, st.u_scale, st.v,
                st.v_scale, me, ge if proj == "w2" else None, None, eb,
                ranks, rows)
        out[T] = {p: _ms(f"fused crossover {proj} {p} C={T}", time_ms(
            lambda: qm._launch_fused(p, *args, **kw), 10, flush))
                  for p in ("simt", "mma")}
        log(f"  fused crossover {proj} C={T} rows={rows.tolist()}: CUDA "
            f"cores {out[T]['simt']:.4f} ms, tensor cores "
            f"{out[T]['mma']:.4f} ms on the device (the wrapper takes "
            f"{qm.fused_path(T)}; FUSED_MMA_MIN_C {qm.FUSED_MMA_MIN_C})")
        del xe, me, ge, args
    return out


def timing_phase(dev, sl):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = sl["cfg"]
    B = sl["B"]
    E = cfg.moe.num_experts
    table = {}
    # fused projection at decode (C = B tokens per expert, exact capacity)
    # and at prefill (C = B*P); top-n = 1 of top-2 -> about half the
    # slots compensated.  At prefill also both main-kernel paths and the
    # parts of the call (rank-space pre-pass, main kernel)
    cross = {}
    for proj in ("w1", "w2"):
        st = sl["stacks"][0][proj]
        K = st.shape[1]
        kw = dict(bits=st.bits, group_size=st.group_size)
        eb, ranks = st.meta_tensors()
        for C in (B, B * sl["P"]):
            xe, me, ge, rows = dispatch_like(gen, dev, E, C, K,
                                             cfg.moe.top_k,
                                             cfg.moe.quant.top_n_restore)
            ge = ge if proj == "w2" else None
            args = (xe, st.planes, st.scale, st.zero, st.u, st.u_scale,
                    st.v, st.v_scale, me, ge, None, eb, ranks, rows)
            kt = time_ms(lambda: qm.fused_expert_matmul(
                *args, require_kernel=True, **kw), 10, flush)
            pt = time_ms(lambda: qm.fused_expert_matmul_plain(*args, **kw),
                         3, flush)
            nb, ops = fused_bytes_ops(xe, st, me, ge, rows)
            bms, by = bound(nb, ops)
            tms, tby = tc_bound(nb, ops)
            log(f"  fused {proj} E={E} C={C} K={K} N={st.shape[2]} "
                f"bits={st.bits} rows={rows.tolist()} "
                f"path={qm.fused_path(C)}: kernel {_fmt(kt)}; plain "
                f"{_fmt(pt)}; bound f32 CUDA cores {bms:.4f} ms ({by}; "
                f"{nb / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), bf16 tensor "
                f"cores x2 {tms:.4f} ms ({tby})")
            if C == B:
                if proj == "w1":
                    table["fused_expert_matmul"] = dict(
                        ms=_ms("fused kernel", kt),
                        plain_ms=_ms("fused plain", pt), bound_ms=bms,
                        bound_by=by, library_ms=None)
                del xe, me, ge
                continue
            # prefill: the parts of the call on each path; the tensor-core
            # main kernel also without its compensation epilogue (rank cap
            # 0) and with every slot empty (only the zero writes)
            parts = {"prepass": time_ms(lambda: qm._fused_parts(
                ("prepass",), *args, **kw), 10, flush)}
            for path in ("simt", "mma"):
                parts[f"{path} main"] = time_ms(lambda: qm._fused_parts(
                    (path,), *args, **kw), 10, flush)
                parts[f"{path} all"] = time_ms(lambda: qm._launch_fused(
                    path, *args, **kw), 10, flush)
            cap0 = torch.zeros((1,), dtype=torch.int32, device=dev)
            variants = {"cap 0": args[:10] + (cap0,) + args[11:],
                        "rows 0": args[:13] + (torch.zeros_like(rows),)}
            for name, a in variants.items():
                parts[f"mma main {name}"] = time_ms(
                    lambda: qm._fused_parts(("mma",), *a, **kw),
                    10, flush)
            log(f"  fused {proj} C={C} parts, ms on the device: rank-space "
                f"pre-pass {parts['prepass']['device']:.4f}; CUDA-core main "
                f"kernel {parts['simt main']['device']:.4f} (call "
                f"{parts['simt all']['device']:.4f}); tensor-core main "
                f"kernel {parts['mma main']['device']:.4f} (call "
                f"{parts['mma all']['device']:.4f}; main kernel with rank "
                f"cap 0 {parts['mma main cap 0']['device']:.4f}, with every "
                f"slot empty {parts['mma main rows 0']['device']:.4f}: "
                f"{4 * E * C * st.shape[2] / 1e6:.1f} MB of zeros)")
            if proj == "w1":
                table["fused_expert_matmul"].update(
                    prefill_ms=_ms("fused prefill kernel", kt),
                    prefill_plain_ms=_ms("fused prefill plain", pt),
                    prefill_bound_ms=tms, prefill_bound_by=tby,
                    prefill_bound_f32_ms=bms,
                    prefill_simt_ms=_ms("fused prefill CUDA-core path",
                                        parts["simt all"]),
                    prefill_prepass_ms=_ms("fused prefill pre-pass",
                                           parts["prepass"]))
            del xe, me, ge, args
        cross[proj] = fused_crossover(dev, gen, st, cfg, flush, proj)
    for T, t1 in cross["w1"].items():
        t2 = cross["w2"][T]
        layer = {p: 2 * t1[p] + t2[p] for p in t1}
        log(f"  fused crossover per MoE layer (w1 + w3 + w2) C={T}: CUDA "
            f"cores {layer['simt']:.4f} ms, tensor cores {layer['mma']:.4f}"
            f" ms")
    # flash decode at the slice's decode shape: f32 cache of bucket length
    table["flash_decode_attention"] = flash_slice_timing(dev, gen, flush, sl)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, name in enumerate(("f32", "bf16", "int8")):
        cap = fd.cluster_capacity(dev, kind, 128, 4)
        log(f"  flash_decode kv={name} hd=128 G=4: clusters resident at once "
            f"by size (cudaOccupancyMaxActiveClusters) " + ", ".join(
                f"{cl}: {cap(cl)}" for cl in fd.CLUSTERS) + f"; {sms} SMs")
    table["flash_decode_attention"].update(flash_long_timing(dev, gen, flush))
    return table


# ---------------------------------------------------------------------------
# phase 5: the dense slice (Llama-3.2-3B, E = 1 stacks)
# ---------------------------------------------------------------------------

def dense_config():
    from repro_torch.registry import get_config
    cfg = get_config("llama3.2-3b")
    q = cfg.quant
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}"
        f"/{cfg.num_kv_heads} kv, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, bits "
        f"{q.bits}, group {q.group_size}, rank_budget {q.rank_budget}")
    log(f"  depth {cfg.num_layers} layers, as published (no cut)")
    return cfg


def dense_phase(dev):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params)
    from repro_torch.serve.engine import ServeEngine
    cfg = dense_config()
    B, P, NEW = 4, 256, 32
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, cfg_q = compress_dense_params(params, cfg)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    stacks = qparams["layers"][0]["ffn"]["stacks"]
    log(f"  init {t_init:.2f} s; compression {t_comp:.2f} s "
        f"({cfg.num_layers} dense layers x 3 E=1 stacks; layer-0 ranks "
        f"{ {k: st.ranks[0] for k, st in stacks.items()} }); device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after compression")

    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    sv = serve_slice(dev, cfg_q, qparams, prompts, NEW, {
        "quant_matmul": qm.qmm_launches,
        "flash_decode_attention": fd.launches,
        "fused_expert_matmul": qm.launches})
    eng, res, launches = sv["engine"], sv["graph"], sv["launches"]
    if min(launches["quant_matmul"], launches["flash_decode_attention"]) <= 0:
        fail(f"a kernel of the dense path was never launched: {launches}")
    check_generation(res, B, NEW, cfg.vocab_size)
    if res.router_trace is not None:
        fail("a dense model returned a router trace")
    ref = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="ref",
                      device=dev)
    teacher_forced(eng, ref, prompts, res.tokens, 0)
    return {"launches": launches, "eager_launches": sv["eager_launches"],
            "stacks": stacks, "cfg": cfg_q,
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW}


def qmm_bytes_ops(M, K, N, planes, R):
    """Least bytes and operations of one compensated quant_matmul: x, the
    packed planes, f32 scale/zero at g64, the int8 U/V of rank R and
    their scales, the mask, each read once; the output written once."""
    nb = (4 * M * K + sum(p.numel() for p in planes) + 2 * 4 * (K // 64) * N
          + R * (K + N) + 8 * R + 4 * M + 4 * M * N)
    return nb, 2 * M * K * N + 2 * M * R * (K + N)


def qmm_crossover(dev, gen, st, qt, flush, proj):
    """One projection at small M on both kernel paths (split-K on the CUDA
    cores, the tensor-core tile): {M: {path: device ms}}, the timings the
    path threshold MMA_MIN_M rests on."""
    from repro_torch.kernels import quant_matmul as qm
    K, N = qt.shape
    kw = dict(bits=qt.bits, group_size=qt.group_size)
    out = {}
    for M in (16, 32, 64, 96, 128, 256):
        x = torch.randn((M, K), generator=gen, device=dev)
        args = (x, qt.planes, qt.scale, qt.zero, st.u[0], st.u_scale[0],
                st.v[0], st.v_scale[0], torch.ones((M,), device=dev), None)
        out[M] = {p: _ms(f"crossover {proj} {p} M={M}", time_ms(
            lambda: qm._launch_qmm(p, *args, **kw), 10, flush))
                  for p in ("splitk", "mma")}
        log(f"  crossover {proj} M={M}: split-K {out[M]['splitk']:.4f} ms, "
            f"tensor cores {out[M]['mma']:.4f} ms on the device (the "
            f"wrapper takes {qm.qmm_path(M)}; MMA_MIN_M {qm.MMA_MIN_M})")
    return out


def dense_timing(dev, sl):
    """Kernel 3 on the dense slice's layer-0 stacks at decode (M = B) and
    prefill (M = B*P), every token compensated, beside its plain version,
    its bounds (f32 CUDA cores and, for the tensor-core path, bf16 tensor
    cores), and (context only) cuBLAS ``x @ W`` on the dequantized f32
    weight; w1 and w2 on both paths at small M (the path threshold); and
    flash-decode at the dense slice's decode shape (G = 3)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ref import dequant_ref
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    cfg = sl["cfg"]
    B = sl["B"]
    table, cross = {}, {}
    for proj in ("w1", "w3", "w2"):
        st = sl["stacks"][proj]
        qt = ops.stack_member(st, 0)
        K, N = qt.shape
        w = dequant_ref(qt.planes, qt.scale, qt.zero, qt.bits, qt.group_size)
        for M in (B, B * sl["P"]):
            x = torch.randn((M, K), generator=gen, device=dev)
            args = (x, qt.planes, qt.scale, qt.zero, st.u[0], st.u_scale[0],
                    st.v[0], st.v_scale[0], torch.ones((M,), device=dev),
                    None)
            kw = dict(bits=qt.bits, group_size=qt.group_size)
            kt = time_ms(lambda: qm.quant_matmul(
                *args, require_kernel=True, **kw), 20, flush)
            pt = time_ms(lambda: qm.quant_matmul_plain(*args, **kw), 3,
                         flush)
            dt = time_ms(lambda: x @ w, 10, flush)
            nb, ops_n = qmm_bytes_ops(M, K, N, qt.planes, st.pad_rank)
            bms, by = bound(nb, ops_n)
            tms, tby = tc_bound(nb, ops_n)
            ks, kch = qm.qmm_splits(M, K, N)
            log(f"  quant_matmul {proj} M={M} K={K} N={N} bits={qt.bits} "
                f"R={st.pad_rank} path={qm.qmm_path(M)} K-splits={ks}: "
                f"kernel {_fmt(kt)}; plain {_fmt(pt)}; dense f32 cuBLAS "
                f"x@W (16x the weight bytes, context) {_fmt(dt)}; bound "
                f"f32 CUDA cores {bms:.4f} ms ({by}; {nb / 1e6:.2f} MB, "
                f"{ops_n / 1e9:.3f} GFLOP), bf16 tensor cores x2 "
                f"{tms:.4f} ms ({tby})")
            if proj == "w1" and M == B:
                table["quant_matmul"] = dict(
                    ms=_ms("quant_matmul kernel", kt),
                    plain_ms=_ms("quant_matmul plain", pt), bound_ms=bms,
                    bound_by=by, library_ms=None)
            if proj == "w1" and M == B * sl["P"]:
                table["quant_matmul"].update(
                    prefill_ms=_ms("quant_matmul prefill kernel", kt),
                    prefill_plain_ms=_ms("quant_matmul prefill plain", pt),
                    prefill_bound_ms=tms, prefill_bound_by=tby,
                    prefill_bound_f32_ms=bms)
            del x, args
        del w
        if proj in ("w1", "w2"):
            cross[proj] = qmm_crossover(dev, gen, st, qt, flush, proj)
    for M, t1 in cross["w1"].items():
        t2 = cross["w2"][M]
        layer = {p: 2 * t1[p] + t2[p] for p in t1}
        log(f"  crossover per layer (w1 + w3 + w2) M={M}: split-K "
            f"{layer['splitk']:.4f} ms, tensor cores {layer['mma']:.4f} ms")
    flash_slice_timing(dev, gen, flush, sl)
    return table


def profiled(fn):
    """Run ``fn`` and synchronise under the profiler.  Returns ([(kernel
    name, device ms)], host-clock s): each device kernel the profiler saw,
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    seen = {(ev.name, ev.time_range.start, ev.time_range.end): ev
            for ev in prof.events() if ev.device_type == DeviceType.CUDA}
    return [(name, ev.time_range.elapsed_us() / 1e3)
            for (name, _, _), ev in seen.items()], wall


def log_top(kernels, per: int, what: str) -> None:
    """The 8 kernel names of ``profiled``'s kernels with the most device
    time, per ``what``."""
    ms_by_name = {}
    for name, ms in kernels:
        ms_by_name[name] = ms_by_name.get(name, 0.0) + ms
    for name, ms in sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms / per:8.4f} ms/{what}  {name[:100]}")


def profile_decode(eng, prompts, step_s: float, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``eng.decode`` over ``steps``
    steps under the profiler (graph replays on a graph engine, eager
    steps otherwise), the device time of every kernel against the
    host-clock time of a step with the profiler on and of ``step_s`` (a
    step of the unprofiled ``generate`` run); the card's idle share is
    1 - device / step.

    On a graph engine the bucket's graph is also replayed alone: under
    the profiler (the kernels it holds, captured once and launched by one
    ``cudaGraphLaunch``) and between CUDA events (its span on the device,
    gaps between its kernels included).  A step's other kernels are the
    eager ops between replays (sampling, log-prob, the token and trace
    copies), so the host launches per step are those ops plus one."""
    logits, caches = eng.prefill(prompts, steps + 1)
    torch.cuda.synchronize()
    kernels, wall = profiled(lambda: eng.decode(logits, caches, steps))
    busy = sum(ms for _, ms in kernels) / steps
    kps = len(kernels) / steps
    out = {"host_ms": step_s * 1e3, "busy_ms": busy,
           "idle": 1 - busy / (step_s * 1e3), "launches": f"{kps:.1f}"}
    mode = "eager loop"
    if eng.decode_graph:
        mode = "graph replays"
        g = next(g for g in eng.graphs.values() if g.caches is caches)
        replayed, _ = profiled(lambda: [g.graph.replay()
                                        for _ in range(steps)])
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                            device=eng.device)
        span = time_ms(g.graph.replay, 10, flush)
        if not replayed:
            fail("the profiler saw no kernel of a replayed graph")
        captured = len(replayed) / steps
        rbusy = sum(ms for _, ms in replayed) / steps
        out["launches"] = (f"{kps - captured + 1:.1f} host ({captured:.1f} "
                           f"captured kernels in 1 graph launch + "
                           f"{kps - captured:.1f} eager ops)")
        log(f"  graph alone, {steps} replays: {captured:.1f} kernels, "
            f"device busy {rbusy:.3f} ms/replay (profiler); span "
            f"{_fmt(span)} (CUDA events)")
    log(f"  decode profile ({mode}), {steps} steps: device busy "
        f"{out['busy_ms']:.3f} ms/step; host clock {step_s * 1e3:.3f} "
        f"ms/step unprofiled (idle share {out['idle']:.3f}), "
        f"{wall * 1e3 / steps:.3f} ms/step profiled; kernels on the device "
        f"per step {kps:.1f}")
    log_top(kernels, steps, "step")
    return out


def profile_prefill(eng, prompts, max_new: int, prefill_s: float) -> None:
    """Where a prefill's time goes, as ``profile_decode`` for decode: one
    ``eng.prefill`` under the profiler, its device time by kernel (top 8)
    against the host clock of the timed run's unprofiled prefill
    (``prefill_s``) and of the profiled one."""
    kernels, wall = profiled(lambda: eng.prefill(prompts, max_new))
    busy = sum(ms for _, ms in kernels)
    log(f"  prefill profile, {prompts.shape[0]} x {prompts.shape[1]} tokens:"
        f" device busy {busy:.3f} ms; host clock {prefill_s * 1e3:.3f} ms "
        f"unprofiled (idle share {1 - busy / (prefill_s * 1e3):.3f}), "
        f"{wall * 1e3:.3f} ms profiled; kernels {len(kernels)}")
    log_top(kernels, 1, "prefill")


def kernel_resources(ptxas_log: str, cufilt: Path):
    """(kernel<template args>, 'N registers, ...; spills') for each kernel
    that ``-Xptxas -v`` reports in a build log, named by the toolkit's
    ``cu++filt`` (the mangled name where it is missing)."""
    out, name, spill = [], None, ""
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append((name, f"{line.split(':', 1)[-1].strip()}; {spill}"))
            name = None
    if not out or not cufilt.exists():
        return out
    names = subprocess.run([str(cufilt)], input="\n".join(n for n, _ in out),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    short = [re.search(r"(\w+(?:<.*?>)?)\(", n) for n in names]
    return [(m.group(1) if m else n, regs)
            for m, n, (_, regs) in zip(short, names, out)]


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"error: the repro_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: preflight")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{[p.name for p in paths.values()]}")
    cufilt = Path(build.nvcc_path()).with_name("cu++filt")
    for src in build.SOURCES:
        for name, regs in kernel_resources(build.build_log(src), cufilt):
            log(f"    {src}: {name}: {regs}")

    log("== phase 2: kernels vs plain versions")
    errs = kernel_phase(dev)

    log("== phase 3: serving slice")
    sl = slice_phase(dev)

    log("== phase 4: timing")
    table = timing_phase(dev, sl)
    table["fused_expert_matmul"]["launches_mma"] = sl["mma_launches"]
    moe = {k: sl[k] for k in ("launches", "eager_launches", "compress_s",
                              "prefill_ms", "decode_tok_s", "eager_tok_s")}
    del sl
    torch.cuda.empty_cache()

    log("== phase 5: dense slice (Llama-3.2-3B)")
    dl = dense_phase(dev)
    table.update(dense_timing(dev, dl))
    src = {"fused_expert_matmul": (
        "src/repro_torch/kernels/csrc/fused_expert.cu",
        "src/repro/kernels/quant_matmul.py:241"),
        "flash_decode_attention": (
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/decode_attention.py:73"),
        "quant_matmul": (
        "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:87")}
    kernels = []
    for name, (path, replaces) in src.items():
        by_path = {"mixtral": moe["launches"].get(name, 0),
                   "llama": dl["launches"].get(name, 0)}
        eager_by_path = {"mixtral": moe["eager_launches"].get(name, 0),
                         "llama": dl["eager_launches"].get(name, 0)}
        kernels.append(dict(name=name, route="cuda", source=path,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            launches_eager_by_path=eager_by_path,
                            max_abs_err=errs[name], **table[name]))
    for name, r in (("Mixtral slice", moe), ("Llama slice", dl)):
        log(f"  {name}: compression {r['compress_s']:.2f} s, prefill "
            f"{r['prefill_ms']:.2f} ms, decode {r['decode_tok_s']:.2f} "
            f"tok/s with the graph, {r['eager_tok_s']:.2f} eager")
    log(f"  total run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
