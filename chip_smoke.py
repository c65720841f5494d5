#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # on a machine with an H100

Phases:
  1. preflight  the card's name and power limit; build the CUDA kernels
                from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
                one nvcc per source, in parallel
  2. kernels    hold each kernel against its plain PyTorch version on the
                card, at the shapes of the Mixtral-8x7B, Llama-3.2-3B,
                DeepSeek-MoE-16B and Qwen3-MoE-30B-A3B serving paths
                (kernel 1 at DeepSeek's E 64, top-6 dispatch and pad_rank
                1024, and at Qwen3's E 128, top-8, experts at 2..8 bits in
                one container, on both main-kernel paths, against the
                plain version in f64; flash-decode at Qwen3's G 8;
                flash-decode's block-table mode against gather + the
                contiguous kernel, bit for bit, at Mixtral's, DeepSeek's
                and Qwen3's shapes; its multi-query mode, Q 2, 4 and 8
                query positions per row, contiguous and paged, f32, bf16
                and int8, S 512 and 32768, against Q single-query calls
                bit for bit; flash-decode at RecurrentGemma-9B's G 16 (hd
                256, S 2048, with and without its window of 2048, f32,
                bf16 and int8) and at G 9, kernel 3 at its projections
                4096 -> 12288 -> 4096 at M 1, 4 and 512)
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
                on both of its paths (decode kernel, prefill tile), split
                into its rank-space pre-pass and main kernel, beside both
                its bounds, and both paths at smaller C (the crossover
                FUSED_MMA_MIN_C rests on); flash-decode at the slice's
                S 512 and at long context (S 4096, 32768) for each cache
                type, beside its byte bound, its rate and SDPA; its
                block-table mode at S 512 and 32768 against the
                contiguous call at the same S and against gather + kernel;
                its multi-query mode at Q 4 (Mixtral's and DeepSeek's
                shapes, S 512 and 32768, contiguous and paged) against 4
                single-query calls, its bound, the plain version and SDPA
                with an explicit mask; its window mode at
                RecurrentGemma-9B's G 16 ring (B 4, hd 256, S 2048 =
                window, bf16 and f32) beside its bound, the plain version
                and SDPA with the window in an explicit mask
  5. dense      Llama-3.2-3B at its published config (28 layers, dense
                FFNs compressed to E = 1 stacks): the same as phase 3
                (graph against eager, the profiles, teacher-forced),
                then the dense-path kernels timed as in phase 4, with
                quant_matmul's decode kernel (its cluster geometry, the
                call and the K walk alone, one kernel per call by the
                profiler's names), its prefill (tensor-core path) beside
                both its bounds and w1/w2 on both of its paths at small M
  6. bf16       phases 3 and 5 again, the weights initialised and
                compressed in bf16, each held to a bf16 impl='ref' engine
                under LOGIT_TOL_BF16
  7. deepseek   DeepSeek-MoE-16B at its published config (28 layers: a
                dense layer 0, 27 MoE layers of 64 experts top-6 with 2
                shared experts, top-n 3), bf16: compress on the card,
                serve as phase 3 (graph against eager, the profiles,
                teacher-forced against impl='ref' in bf16), then kernel 1
                at its shapes and flash-decode at its G 1 timed as in
                phase 4
  8. serve      ``ServeEngine.serve`` (continuous batching on 4 slots,
                chunks of 8 decode steps through the decode graph) with
                byte-metered expert offload (policy 'ours'): on phase 3's
                Mixtral against ``generate`` of the same prompts, a ragged
                workload with the graph against the eager loop under a
                bandwidth budget, and ``score`` against impl='ref'; on
                phase 7's DeepSeek-MoE 16 ragged requests twice
                (identical; tokens/s, TTFT, latency, bytes/token, hit
                rate, host metering ms per chunk, the card's idle share),
                then the bandwidth controller: static plan, top_n 0, a
                budget between them (tail bytes/token within [lo, hi] and
                closer to the budget than the static plan's), repeated
  9. entry      Qwen3-MoE-30B-A3B at its published widths, depth cut to
                QWEN3_LAYERS, f32, through the system's own entry points:
                ``repro_torch.launch.compress``'s ``run`` (calibrate on 4 x
                8 x 128 synthetic tokens, allocate per-expert bits and
                ranks under 0.9 of the uniform INT2 + rank-64 bytes,
                compress, write the artifact to a temporary directory),
                then ``repro_torch.launch.serve``'s ``run`` booting it
                (offload, 16 requests on 4 slots, chunks of 8, prompts of
                256..512, 32 new, LRU 32 of 128 experts): the loaded
                stacks equal the in-memory ones bit for bit, serving them
                in memory gives the same tokens, traces, reports and
                bytes, teacher-forced logits within LOGIT_TOL of
                impl='ref'; kernel 1 on the plan's stacks (E 128, top-8,
                heterogeneous widths and ranks) on both paths in f64;
                kernel 1 and flash-decode at G 8 (S 512, 1024) timed
 10. stream     async expert streaming, run right after phase 8 on its
                weights and stacks (before phase 9, which needs the
                memory): each engine's experts in a pinned host image,
                its MoE layers serving from fallback-booted device
                containers, every metered byte copied on a copy stream
                (CUDA events around each copy give the link rate).
                Mixtral-8x7B (f32, 2 layers): phase 8's "serve = generate"
                workload under 'block' at cache 8 and LRU 3 of 8, tokens
                and traces equal to phase 8's resident serve, metered ==
                observed bytes per store, the graph captured before
                ``attach_streaming`` dropped, a warm serve copying
                nothing; DeepSeek-MoE-16B (bf16, 28 layers): phase 8's
                16 requests under 'block' twice (equal to phase 8's
                resident run and to each other, the second profiled for
                the idle share), then under 'degrade'; wire and physical
                MB/token, link GB/s, stall/transfer/sync seconds, overlap
                efficiency, re-runs, pin seconds, MemAvailable, peak
                device memory; then pinned H2D copy rates (one expert
                payload, 1 GiB)
 11. paged      the paged KV cache, run right after phase 10 on phase 8's
                engines (before phase 9): Mixtral-8x7B (f32, 2 layers),
                phase 8's ragged workload paged at page 16 against the
                contiguous cache (tokens, traces and metered bytes equal
                but for a first divergence at an f32 near-tie; one
                capture for the paged envelope, none for a second
                workload in it; no page leaked; a smaller cache), then
                paged under streaming 'block' at LRU 3 equal to the
                resident paged serve; DeepSeek-MoE-16B (bf16, 28 layers),
                phase 8's 16 requests paged against phase 8's run (a bf16
                near-tie protocol), then 16 requests sharing a 256-token
                system prompt with prefix reuse off and on (prefill
                tokens, hit rate, peak shared ref, TTFT), one admission's
                full and suffix prefill profiled, and ``simulate_decode``
                on the served trace under the paper's profiles and the
                measured per-copy link rate (the ``projection`` line)
 12. spec       speculative decoding, run right after phase 11 on phase
                8's engines (before phase 9): Mixtral-8x7B (f32, 2
                layers), phase 8's "serve = generate" workload in rounds
                (n-gram drafts at k 3 and 1, the 'model' and 'self'
                drafters, a drafter that is always wrong, paged at page
                16, streamed 'block' at LRU 3), each equal to phase 8's
                plain serve but for first divergences at f32 near-ties,
                one verify-graph capture per key, acceptance exactly 0
                for the wrong drafter, metered == observed bytes
                streamed; DeepSeek-MoE-16B (bf16, 28 layers), phase 8's
                16 requests at k 3 twice (the second profiled for the
                idle share), tokens equal phase 8's but for bf16 near-tie
                first divergences (counted), then 4 of them at
                temperature 0.8; lines start ``mixtral spec``,
                ``deepseek spec`` (acceptance, mean accepted length,
                lookahead accuracy and MB, draft-overhead MB, wire
                MB/token, decode tok/s over rounds, TTFT, drafter and
                verify ms per round)
 13. window     sliding-window models, run after phase 12: Gemma3-1B (26
                layers, f32), Gemma3-27B (bf16, GEMMA3_27B_LAYERS) and
                Qwen2-7B (bf16, QWEN2_LAYERS, seeded QKV biases) through
                ``serve_slice`` and ``teacher_forced``, the eager loop's
                launches counted exactly; Gemma3-1B's serve of 16
                requests; flash-decode's window mode timed at both Gemma3
                rings, kernel 3 at Gemma3-27B's projections
 14. stateful   the stateful mixers, run after phase 13 (before phase 9):
                Gemma3-1B's 16 requests served again at page 16 (its
                global layers paged, the rings slot-indexed beside the
                pools) against phase 13's contiguous run; RecurrentGemma-9B
                at published widths, RECURRENTGEMMA_LAYERS deep (4
                recurrent, 2 local layers), bf16, 4 prompts of 2040 tokens
                and 32 new (decode wraps the 2048-slot rings) through
                ``serve_slice`` and ``teacher_forced`` (LOGIT_TOL_BF16),
                the eager loop's launches counted exactly, the RG-LRU gate
                matrices' share of the graph's step; its serve of 8
                requests contiguous (each request against ``generate`` of
                its prompt alone) and at page 16 (equal); kernel 3 at
                its projections timed (M 4);
                xLSTM-125M (12 layers, f32, unquantized: no TPU kernel on
                its path), 4 prompts of 512 tokens, graph against eager,
                prefill-then-decode against one forward pass (LOGIT_TOL);
                both mixed plans refuse prefix reuse and speculation

 15. train      training and the last of the model zoo, run after phase
                14 (before phase 9): (a) ``train()`` on DeepSeek-MoE-16B at
                full width, TRAIN_LAYERS deep (dense layer 0, 2 MoE layers),
                f32, 8 steps of SyntheticLM batches of 4 x 1024 with the
                chunked fused cross entropy and per-layer recomputation,
                twice: batches drawn before the run, then train()'s own
                draw inside each step (histories equal bit for bit), one
                step profiled, the plain against the fused cross entropy;
                (b) kill at
                step 5 of 10 and resume on the reduced config (equal to
                the uninterrupted run bit for bit, within RESUME_CPU_TOL
                of the CPU's); (c) Whisper-base, no cut, f32, 1500 seeded
                frames, 3-bit E = 1 decoder FFNs: make_prefill_step and 32
                make_serve_step steps against impl='ref' (LOGIT_TOL),
                launches exact (kernel 2 at G 1, hd 64; kernel 3 at 3
                bits), one train step with the frames, both kernels timed
                at its shapes; (d) Qwen2-VL-7B, QWEN2_VL_LAYERS deep, bf16,
                a 12 x 16 image grid between text at M-RoPE positions,
                against a bf16 'ref' run (LOGIT_TOL_BF16), and the
                ServeEngine's text path = the step builders at t = h = w
 16. ep         expert-parallel serving, run after phase 15 (before phase
                9), on meshes of 2 ranks (processes, gloo collectives,
                every rank on cuda:0): (a) kernel 1 on each shard's
                experts (ep 2 and 4, the shard's own widths and ranks)
                against the full-E call's rows and the plain version in
                f64; (b) Mixtral-8x7B (phase 3's weights through an
                artifact, each rank loading its slice): generate = phase
                3's eager loop (tokens and traces), teacher-forced against
                a single-device engine, tok/s, collectives' host ms per
                step, peak memory per rank; (c) serve with offload
                metering (bytes, hits and per-shard bytes = the
                single-device engine's through attach_offload(ep=2)), a
                per_shard budget's plan trace, paged and speculative
                serving; (d) DeepSeek-MoE-16B (bf16, EP_DEEPSEEK_LAYERS
                deep) under the bf16 protocol, and (d') the same weights
                in f32: teacher-forced within LOGIT_TOL, greedy tokens
                and traces equal up to f32 near-ties; (e) the serve CLI
                with --mesh ep=2 --dist-backend gloo.  Launches are
                counted over generate alone

It prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line; without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
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
# the same in bf16 (PERF.md §2, set before the first bf16 run on the card
# from a CPU estimate at narrow width: 28 layers of DeepSeek-MoE's shape
# gave 1.2-2.7% and 14 layers 1.0-2.9% of max |logit| between the two
# engines, router flips in most steps, up to 5% apart in probability;
# 28 dense layers 1.0-2.0%; serving without compensation 5.8-6.8%).  Both
# engines round activations to bf16, at different places (the kernel
# path rounds the gated hidden before w2 and folds the gates in f32, the
# plain path keeps the hidden in f32 and gates in bf16), so they differ
# by bf16 steps that 28 layers carry forward, and top-6 of 64 experts
# flips near-ties in most steps.  In bf16 a flip keeps the row compared:
# the limit covers the flipped expert's contribution
LOGIT_TOL_BF16 = 0.05
NEAR_TIE_BF16 = 0.1     # |p_a - p_b| <= NEAR_TIE_BF16 * the k-th largest p
# in bf16 a row whose router flipped at a near-tie is not compared at that
# step when a flipped expert carries more than this gate weight (Mixtral's
# normalised top-2 gates: ~0.5, half the layer's output); below it (the
# unnormalised top-6 of 64 of DeepSeek-MoE: ~0.03) it is compared
FLIP_GATE_BF16 = 0.1
# log-probs of the graph-replayed decode loop against the eager loop: the
# same kernels on the same inputs, so |diff| <= 1e-5 (tokens and router
# trace must be identical)
GRAPH_LP_TOL = 1e-5
# score (mean NLL over 4 x 256 tokens), kernel engine vs impl='ref' engine,
# f32: the prefill-shaped kernel 1 sums in another order (the tensor-core
# hi/lo path), so relative |diff| <= 1e-4
SCORE_TOL = 1e-4


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
    projections at decode (M 4, the one-launch decode kernel, K split
    over a cluster) and prefill (M 1024, tensor-core path), 2 bits, rank
    32, every token compensated; then other widths, ragged M on both
    paths, the decode kernel's token tiles of 1 and 2 (M 1, 2, 3), a K
    whose pack blocks the cluster does not split evenly (K 1408, 22 pack
    blocks), a mask with zeros, a rank cap below R, and no compensation
    at all."""
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
    # the decode kernel's edges: token tiles of 1 and 2, uneven K splits
    cases += [("w1", 1, 3072, 8192, 2, "ones", None),
              ("w2", 2, 8192, 3072, 2, "half", None),
              ("w1", 3, 3072, 8192, 3, "half", 20),
              ("w2", 3, 8192, 3072, 2, None, None),
              ("k1408", 4, 1408, 2048, 2, "half", 20),
              ("k1408", 16, 1408, 2048, 3, "ones", None)]
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
        if qm.qmm_path(M) == "splitk":
            cs, kch = qm.decode_splits(dev, M, K, N, 32 if mask_mode else 0,
                                       bits)
            name += f" cluster={cs}x{kch}"
        mx = allclose_report(name, got, ref, **FUSED_TOL)
        worst = max(worst, mx)
        log(f"  ok  {name}  max|diff| {mx:.3e}")
        del args, got, ref
    return worst


def deepseek_decode_cases(dev, gen) -> float:
    """Kernel 1's rank-space work at DeepSeek-MoE-16B's decode shapes (E
    64, top-6 with top-n 3, pad_rank 1024) at C 4 (a decode step) and C 16
    (a verify round): four experts of rank 1024, each holding a
    compensated and an uncompensated row in one token tile (slots 0 and
    1), four more at ranks 1000, 517, 64 and 3, rank cap none and 700;
    both main-kernel paths forced, against the plain version in f64.
    Returns the largest |diff|."""
    from repro_torch.kernels import quant_matmul as qm
    worst = 0.0
    for K, N in ((2048, 1408), (1408, 2048)):
        for T in (4, 16):
            xe, me, ge, rows = dispatch_like(gen, dev, 64, T, K, 6, 3)
            args = list(random_stack_inputs(gen, dev, 64, 1, K, N, 1024, 2,
                                            False, "full", False))
            order = torch.argsort(rows, descending=True, stable=True)
            mixed = order[:4]
            for e in mixed.tolist():
                for s in range(int(rows[e]), 2):    # give it two rows
                    xe[e, s] = torch.randn((K,), generator=gen, device=dev)
                    ge[e, s] = 1.0 / 6
                me[e, 0], me[e, 1] = 1.0, 0.0
            rows[mixed] = rows[mixed].clamp(min=2)
            ranks = torch.zeros((64,), dtype=torch.int32, device=dev)
            ranks[mixed] = 1024
            ranks[order[4:8]] = torch.tensor([1000, 517, 64, 3],
                                             dtype=torch.int32, device=dev)
            args[0], args[8], args[12], args[13] = xe, me, ranks, rows
            args[9] = ge if K == 1408 else None
            for cap in (None, 700):
                args[10] = None if cap is None else torch.tensor(
                    [cap], dtype=torch.int32, device=dev)
                ref = qm.fused_expert_matmul_plain(xe.double(), *args[1:],
                                                   bits=2, group_size=64)
                for path in ("simt", "mma"):
                    got = qm._launch_fused(path, *args, bits=2,
                                           group_size=64)
                    name = (f"fused deepseek decode path={path} K={K} N={N} "
                            f"C={T} rank 1024 on experts {mixed.tolist()} "
                            f"(slot 0 compensated, slot 1 not), ranks 1000, "
                            f"517, 64, 3 on {order[4:8].tolist()}, cap={cap}"
                            f", gated={args[9] is not None}")
                    mx = allclose_report(name, got, ref, **FUSED_TOL)
                    worst = max(worst, mx)
                    log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref, xe, me, ge
            torch.cuda.empty_cache()
    return worst


def qwen3_fused_cases(dev, gen) -> float:
    """Kernel 1 at Qwen3-MoE-30B-A3B's expert grid (E 128, d_model 2048,
    d_expert 768): top-8-of-128 dispatch with top-n 3 at decode (T 4),
    at serve()'s admissions (T 256, 512: padded prompts) and at prefill
    (T 1024); experts at 2, 3, 4 and 8 bits in an 8-bit container and at
    2, 3 and 4 in a 4-bit one (an allocated plan's heterogeneous widths),
    true ranks 0..256 under pad_rank 256; both main-kernel paths forced,
    against the plain version in f64.  Returns the largest |diff|."""
    from repro_torch.kernels import quant_matmul as qm
    worst = 0.0
    for K, N in ((2048, 768), (768, 2048)):
        for T, container in ((4, 8), (256, 4), (512, 8), (1024, 4)):
            xe, me, ge, rows = dispatch_like(gen, dev, 128, T, K, 8, 3)
            args = list(random_stack_inputs(gen, dev, 128, 1, K, N, 256,
                                            container, False, "full", False))
            widths = [b for b in (2, 3, 4, 8) if b <= container]
            eb = torch.tensor([widths[e % len(widths)] for e in range(128)],
                              dtype=torch.int32, device=dev)
            ranks = torch.tensor([(0, 16, 0, 32, 128, 0, 256)[e % 7]
                                  for e in range(128)], dtype=torch.int32,
                                 device=dev)
            args[0], args[8], args[11], args[12], args[13] = \
                xe, me, eb, ranks, rows
            args[9] = ge if K == 768 else None
            ref = qm.fused_expert_matmul_plain(xe.double(), *args[1:],
                                               bits=container, group_size=64)
            for path in ("simt", "mma"):
                got = qm._launch_fused(path, *args, bits=container,
                                       group_size=64)
                name = (f"fused qwen3 path={path} E=128 K={K} N={N} T={T} "
                        f"top-8 top-n 3 container {container} bits "
                        f"{widths} ranks 0..256 pad_rank 256 live experts "
                        f"{int((rows > 0).sum())} gated={args[9] is not None}")
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                worst = max(worst, mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref, xe, me, ge
            torch.cuda.empty_cache()
    return worst


# the new models' dense FFN projections (K, N) that kernel 3 serves as
# E = 1 stacks: w1 / w3, then w2
ZOO_QMM = {"gemma3_1b": ((1152, 6912), (6912, 1152)),
           "gemma3_27b": ((5376, 21504), (21504, 5376)),
           "qwen2_7b": ((3584, 18944), (18944, 3584)),
           "recurrentgemma_9b": ((4096, 12288), (12288, 4096))}
# Whisper-base's plain MLP (3-bit stacks of rank 16): w1, then w2
ZOO_QMM_3BIT = {"whisper_base": ((512, 2048), (2048, 512))}
# the MoE configs registered without a served cell: (E, top-k, top-n,
# d_model, d_expert)
ZOO_FUSED = {"llama4_scout": (16, 1, 1, 5120, 8192),
             "mixtral_8x22b": (8, 2, 1, 6144, 16384)}


def zoo_kernel_cases(dev, gen) -> tuple:
    """Kernel 3 at each new dense projection (Gemma3-1B, Gemma3-27B,
    Qwen2-7B, RecurrentGemma-9B; 2 bits, rank 32, every token
    compensated) at M 1 and 4 (the decode kernel) and 512 (the tensor
    cores); kernel 1 at
    Llama-4-Scout's (E 16, top-1) and Mixtral-8x22B's (E 8, top-2) expert
    grids, w1 and w2 at T 4 and 1024 of top-k dispatch, pad_rank 64, both
    main-kernel paths forced, against the plain version in f64.  Returns
    (kernel 1's largest |diff|, kernel 3's)."""
    from repro_torch.kernels import quant_matmul as qm
    qmm_worst = fused_worst = 0.0
    for model, projs in ZOO_QMM.items():
        for K, N in projs:
            for M in (1, 4, 512):
                args = qmm_case_inputs(gen, dev, M, K, N, 32, 2)
                got = qm.quant_matmul(*args, bits=2, group_size=64,
                                      require_kernel=True)
                ref = qm.quant_matmul_plain(*args, bits=2, group_size=64)
                name = (f"quant_matmul {model} M={M} K={K} N={N} bits=2 "
                        f"R=32 path={qm.qmm_path(M)}")
                if qm.qmm_path(M) == "splitk":
                    cs, kch = qm.decode_splits(dev, M, K, N, 32, 2)
                    name += f" cluster={cs}x{kch}"
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                qmm_worst = max(qmm_worst, mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
                del args, got, ref
    # Whisper-base's decoder FFN: 3 bits (a 2-bit and a 1-bit plane), rank
    # 16, at M 1 and 4 (the decode kernel) and 256 (a 4 x 64 prefill, the
    # tensor cores)
    for K, N in ZOO_QMM_3BIT["whisper_base"]:
        for M in (1, 4, 256):
            args = qmm_case_inputs(gen, dev, M, K, N, 16, 3)
            got = qm.quant_matmul(*args, bits=3, group_size=64,
                                  require_kernel=True)
            ref = qm.quant_matmul_plain(*args, bits=3, group_size=64)
            name = (f"quant_matmul whisper_base M={M} K={K} N={N} bits=3 "
                    f"R=16 path={qm.qmm_path(M)}")
            if qm.qmm_path(M) == "splitk":
                cs, kch = qm.decode_splits(dev, M, K, N, 16, 3)
                name += f" cluster={cs}x{kch}"
            mx = allclose_report(name, got, ref, **FUSED_TOL)
            qmm_worst = max(qmm_worst, mx)
            log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref
    for model, (E, top_k, top_n, d, fe) in ZOO_FUSED.items():
        for K, N in ((d, fe), (fe, d)):
            for T in (4, 1024):
                xe, me, ge, rows = dispatch_like(gen, dev, E, T, K, top_k,
                                                 top_n)
                args = list(random_stack_inputs(gen, dev, E, 1, K, N, 64, 2,
                                                False, "full", False))
                args[0], args[8], args[13] = xe, me, rows
                args[9] = ge if K == fe else None
                ref = qm.fused_expert_matmul_plain(xe.double(), *args[1:],
                                                   bits=2, group_size=64)
                for path in ("simt", "mma"):
                    got = qm._launch_fused(path, *args, bits=2,
                                           group_size=64)
                    name = (f"fused {model} path={path} E={E} K={K} N={N} "
                            f"T={T} top-{top_k} top-n {top_n} pad_rank 64 "
                            f"live experts {int((rows > 0).sum())} "
                            f"gated={args[9] is not None}")
                    mx = allclose_report(name, got, ref, **FUSED_TOL)
                    fused_worst = max(fused_worst, mx)
                    log(f"  ok  {name}  max|diff| {mx:.3e}")
                del args, got, ref, xe, me, ge
                torch.cuda.empty_cache()
    return fused_worst, qmm_worst


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
    # DeepSeek-MoE-16B's expert grid (E 64, d_model 2048, d_expert 1408):
    # top-6-of-64 dispatch with top-n 3 at decode (T 4), at serve()'s
    # batch-1 admissions (T 64..512: padded prompts of 64..512 tokens), at
    # prefill (T 1024) and ragged (T 1000), pad_rank 1024 on four experts
    # and none on the other 60 (the kurtosis allocation of rank budget
    # 64), both main-kernel paths forced, against the plain version in f64
    for K, N in ((2048, 1408), (1408, 2048)):
        for T in (4, 64, 128, 256, 512, 1000, 1024):
            xe, me, ge, rows = dispatch_like(gen, dev, 64, T, K, 6, 3)
            args = list(random_stack_inputs(gen, dev, 64, 1, K, N, 1024, 2,
                                            False, "full", False))
            live = torch.nonzero(me.sum(dim=1) > 0)[:, 0]
            ranks = torch.zeros((64,), dtype=torch.int32, device=dev)
            ranks[live[:4]] = 1024
            args[0], args[8], args[12], args[13] = xe, me, ranks, rows
            args[9] = ge if K == 1408 else None
            ref = qm.fused_expert_matmul_plain(xe.double(), *args[1:],
                                               bits=2, group_size=64)
            for path in ("simt", "mma"):
                got = qm._launch_fused(path, *args, bits=2, group_size=64)
                name = (f"fused deepseek path={path} E=64 K={K} N={N} "
                        f"T={T} top-6 top-n 3 ranks 1024 on experts "
                        f"{live[:4].tolist()} live experts {live.numel()} "
                        f"gated={args[9] is not None}")
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                errs["fused_expert_matmul"] = max(
                    errs["fused_expert_matmul"], mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
            del args, got, ref, xe, me, ge
            torch.cuda.empty_cache()
    errs["fused_expert_matmul"] = max(errs["fused_expert_matmul"],
                                      deepseek_decode_cases(dev, gen),
                                      qwen3_fused_cases(dev, gen))
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
    zoo_fused, zoo_qmm = zoo_kernel_cases(dev, gen)
    errs["fused_expert_matmul"] = max(errs["fused_expert_matmul"], zoo_fused)
    errs["quant_matmul"] = max(errs["quant_matmul"], zoo_qmm)

    # flash-decode: (B, H, KVH, hd, S, filled, kinds, windows); filled
    # "ring" is a wrapped ring cache, every slot written, positions out of
    # order.  The slices' shapes first (Mixtral G 4, Llama G 3 with a row
    # of no valid slot), then batch 1, 160 rows (a cluster of one), long
    # S, rings with a window, hd 64 and 256, G 1 and G 8, DeepSeek's G 1,
    # then serve()'s (4, 512) and (4, 1024) slot buckets at Mixtral's G 4
    # in f32 and DeepSeek-MoE's G 1 in bf16, each row at its own position
    # (a list of fills: one row still empty at S 512, as an unclaimed
    # slot's)
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
                    (4, 16, 16, 128, 512, 288, ("f32", "bf16", "int8"),
                     (None,)),
                    (4, 64, 8, 128, 1003, 900, ("bf16",), (None,))]
    for S, fills in ((512, [0, 17, 289, 512]), (1024, [41, 301, 701, 1001])):
        flash_cases += [(4, 32, 8, 128, S, fills, ("f32",), (None,)),
                        (4, 16, 16, 128, S, fills, ("bf16",), (None,))]
    # Qwen3-MoE-30B-A3B's G 8 (32 / 4 heads) at its serve buckets, f32
    # as phase 9 serves it (and bf16), rows at one and at their own
    # positions
    for S, fills in ((512, [0, 17, 289, 512]), (1024, [41, 301, 701, 1001])):
        flash_cases += [(4, 32, 4, 128, S, filled, ("f32", "bf16"), (None,))
                        for filled in (288, fills)]
    # the local layers' wrapped rings at decode, window = ring length:
    # Gemma3-1B (G 4, KVH 1, hd 256) in f32 as phase 13 serves it,
    # Gemma3-27B (G 2) in bf16; and Qwen2-7B's G 7 (28 / 4 heads, the G 8
    # instantiation) in bf16, no window
    flash_cases += [(4, 4, 1, 256, 512, "ring", ("f32", "bf16"), (512,)),
                    (4, 32, 16, 128, 1024, "ring", ("bf16",), (1024,)),
                    (4, 28, 4, 128, 512, 288, ("bf16", "f32"), (None,))]
    # RecurrentGemma-9B's local layers, G 16 (16 / 1 heads, hd 256: eight
    # query-head groups of 2) at its window of 2048: the full wrapped ring
    # (window = ring) and a cache of 2040 prompt tokens, with and without
    # the window; and G 9 (four groups of 2 and one of 1)
    flash_cases += [(4, 16, 1, 256, 2048, "ring", ("f32", "bf16", "int8"),
                     (2048,)),
                    (4, 16, 1, 256, 2048, 2040, ("f32", "bf16", "int8"),
                     (None, 2048)),
                    (2, 18, 2, 128, 1000, 700, ("f32", "int8"), (None, 300))]
    # Whisper-base's self-attention (G 1, hd 64: 8 / 8 heads) as phase 15
    # serves it, f32 (and bf16), at S 128 and 2048, all valid and ragged
    flash_cases += [(4, 8, 8, 64, S, filled, ("f32", "bf16"), (None,))
                    for S in (128, 2048) for filled in (S, S * 3 // 4 + 1)]
    errs["flash_decode_attention"] = max(paged_kernel_cases(dev, gen),
                                         multi_query_cases(dev, gen))
    for B, H, KVH, hd, S, filled, kinds, windows in flash_cases:
        for kind in kinds:
            ring = filled == "ring"
            args = flash_inputs(gen, dev, B, H, KVH, hd, S,
                                S if ring else filled, kind, ring)
            spw = fd.slots_per_warp(hd, args[1].element_size())
            cl = fd.launch_geometry(
                B * KVH * fd.group_splits(H // KVH), S, spw,
                fd.cluster_capacity(dev, fd._KV_KIND[args[1].dtype], hd,
                                    H // KVH))
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


def multi_queries(gen, q, cur, nq):
    """Q queries per row for a flash-decode call whose single query is
    ``q`` (B, H, hd) at ``cur`` (B,): fresh (B, nq, H, hd) queries at
    positions cur - nq + 1 .. cur, a verify round's k + 1 positions."""
    b, h, hd = q.shape
    qm = torch.randn((b, nq, h, hd), generator=gen, device=q.device) / \
        math.sqrt(hd)
    curm = cur[:, None] - nq + 1 + torch.arange(
        nq, dtype=torch.int32, device=q.device)[None]
    return qm, curm.to(torch.int32).contiguous()


def multi_query_cases(dev, gen) -> float:
    """Flash-decode's multi-query mode (the verify pass of speculative
    decoding: Q query positions per row) at Mixtral's G 4 and
    DeepSeek-MoE's G 1 (B 4, hd 128), f32, bf16 and int8 caches, Q 2, 4
    and 8, S 512 (rows at their own positions) and 32768 (every slot
    valid), contiguous and paged (page 16): each call equal bit for bit to
    Q single-query calls at the same (B, S) and within DECODE_TOL of the
    plain version.  Returns the largest |kernel - plain|."""
    from repro_torch.kernels import decode_attention as fd
    worst, n = 0.0, 0
    for H, KVH in ((32, 8), (16, 16)):
        for S in (512, 32768):
            fills = [257, 300, 411, 512] if S == 512 else [S] * 4
            for kind in ("f32", "bf16", "int8"):
                for paged in (False, True):
                    if paged:
                        args = paged_flash_inputs(gen, dev, 4, H, KVH, 128,
                                                  16, S // 16, kind, fills)
                        q, cur = args[0], args[5]
                        call = fd.flash_decode_attention_paged
                        plain = fd.flash_decode_attention_paged_plain

                        def with_q(qq, cc, a=args):
                            return (qq,) + a[1:5] + (cc,) + a[6:]
                    else:
                        args = flash_inputs(gen, dev, 4, H, KVH, 128, S,
                                            fills, kind)
                        q, cur = args[0], args[4]
                        call = fd.flash_decode_attention
                        plain = fd.flash_decode_attention_plain

                        def with_q(qq, cc, a=args):
                            return (qq,) + a[1:4] + (cc,) + a[5:]
                    for nq in (2, 4, 8):
                        qm, curm = multi_queries(gen, q, cur, nq)
                        got = call(*with_q(qm, curm), require_kernel=True)
                        singles = torch.stack([call(*with_q(
                            qm[:, i].contiguous(), curm[:, i].contiguous()),
                            require_kernel=True) for i in range(nq)], dim=1)
                        name = (f"flash_decode multi-query B=4 H={H} "
                                f"KVH={KVH} hd=128 S={S} kv={kind} Q={nq} "
                                + ("paged page=16" if paged
                                   else "contiguous"))
                        if not torch.equal(got, singles):
                            fail(f"{name}: differs from {nq} single-query "
                                 f"calls (max |diff| "
                                 f"{float((got - singles).abs().max()):.3e})")
                        mx = allclose_report(name, got, plain(
                            *with_q(qm, curm)), **DECODE_TOL)
                        worst = max(worst, mx)
                        n += 1
                    del args
                    torch.cuda.empty_cache()
            log(f"  ok  flash_decode multi-query H={H} KVH={KVH} S={S}: "
                f"f32/bf16/int8 x Q 2/4/8 x contiguous/paged, each == its "
                f"single-query calls bit for bit")
    log(f"  ok  flash_decode multi-query: {n} cases, max |kernel - plain| "
        f"{worst:.3e} (limit {DECODE_TOL})")
    return worst


def paged_flash_inputs(gen, dev, B, H, KVH, hd, PS, MB, kind="f32",
                       fills=None):
    """Random paged flash-decode arguments (q, k_pool, v_pool, pos_pool,
    block, cur, k_scale, v_scale) over a pool of pages in random physical
    order: with ``fills`` None (B 4), row 0 maps every block (its last
    page partly filled), row 1 shares row 0's leading third and owns a
    shorter span, row 2 maps nothing, row 3 every other block (-1
    between); with ``fills`` (one count per row), each row maps the pages
    its count needs, positions 0..count-1.  The trash page 0 holds finite
    garbage (rows, scales, positions)."""
    q = torch.randn((B, H, hd), generator=gen, device=dev) / math.sqrt(hd)
    block = torch.full((B, MB), -1, dtype=torch.int32)
    perm = torch.randperm(B * MB + 4, generator=torch.Generator()
                          .manual_seed(B * MB + PS)).to(torch.int32) + 1
    if fills is None:
        third = MB // 3
        own = (MB - third) // 2
        block[0] = perm[:MB]
        block[1, :third] = perm[:third]
        block[1, third:third + own] = perm[MB:MB + own]
        block[3, ::2] = perm[2 * MB:2 * MB + (MB + 1) // 2]
        fills = [MB * PS - PS // 2 - 1, (third + own) * PS - 1, 0, MB * PS]
    else:
        used = 0
        for r, f in enumerate(fills):
            n = -(-f // PS)
            block[r, :n] = perm[used:used + n]
            used += n
    P = int(perm.max()) + 1
    k = torch.randn((P, PS, KVH, hd), generator=gen, device=dev)
    v = torch.randn((P, PS, KVH, hd), generator=gen, device=dev)
    pos = torch.full((P, PS), -1, dtype=torch.int32)
    pos[0] = torch.randint(0, MB * PS, (PS,), dtype=torch.int32)
    for r in range(B):
        for j in torch.nonzero(block[r] >= 0)[:, 0].tolist():
            lp = j * PS + torch.arange(PS, dtype=torch.int32)
            pos[block[r, j]] = torch.where(lp < fills[r], lp, -1)
    cur = torch.tensor([max(f, 11) - 1 for f in fills], dtype=torch.int32,
                       device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kind == "int8":
        from repro_torch.models.kvcache import _kv_quant
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    return q, k, v, pos.to(dev), block.to(dev), cur, ks, vs


def gathered(args):
    """The contiguous arguments of a paged call: each row's view gathered
    from the pool (``paged_gather``, the plain route's first half)."""
    from repro_torch.models.kvcache import paged_gather
    q, k, v, pos, block, cur, ks, vs = args
    cache = {"k": k, "v": v, "pos": pos, "block": block}
    if ks is not None:
        cache["k_scale"], cache["v_scale"] = ks, vs
    kf, vf, pf, ksf, vsf = paged_gather(cache)
    return q, kf, vf, pf, cur, ksf, vsf


def paged_kernel_cases(dev, gen) -> float:
    """Flash-decode's block-table mode against gather + the contiguous
    kernel (bit for bit: same logical S, same tiling) and against the
    plain route (DECODE_TOL), at Mixtral's G 4 f32 (page sizes 8, 16, 32;
    int8 at 16; a window), DeepSeek-MoE's G 1 bf16 and Qwen3-MoE's G 8
    f32 and bf16 (page 16), over pages in random order, a page mapped by
    two rows, -1 entries, a row with none mapped and a garbage trash
    page; then three kv heads on one-slot pages (int8 scale words at odd
    offsets).  Returns the largest |kernel - plain|."""
    from repro_torch.kernels import decode_attention as fd
    cases = [(32, 8, ps, "f32", None) for ps in (8, 16, 32)]
    cases += [(32, 8, 16, "int8", None), (32, 8, 16, "f32", 300),
              (16, 16, 16, "bf16", None), (16, 16, 16, "bf16", 300),
              (32, 4, 16, "f32", None), (32, 4, 16, "bf16", None),
              (3, 3, 1, "int8", None), (3, 3, 1, "int8", 40)]
    worst = 0.0
    for H, KVH, PS, kind, window in cases:
        S = 96 if PS == 1 else 1024
        args = paged_flash_inputs(gen, dev, 4, H, KVH, 128, PS, S // PS,
                                  kind)
        got = fd.flash_decode_attention_paged(*args, window=window,
                                              require_kernel=True)
        want = fd.flash_decode_attention(*gathered(args), window=window,
                                         require_kernel=True)
        name = (f"flash_decode paged B=4 H={H} KVH={KVH} hd=128 page={PS} "
                f"blocks={S // PS} kv={kind} window={window}")
        if not torch.equal(got, want):
            fail(f"{name}: block-table mode differs from gather + kernel "
                 f"(max |diff| {float((got - want).abs().max()):.3e})")
        mx = allclose_report(name, got, fd.flash_decode_attention_paged_plain(
            *args, window=window), **DECODE_TOL)
        worst = max(worst, mx)
        log(f"  ok  {name}: == gather + kernel bit for bit; vs plain "
            f"max|diff| {mx:.3e}")
        del args, got, want
    return worst


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


def near_tie(probs_row: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             bf16: bool = False):
    """Two top-k id sets chosen from (nearly) the same probabilities
    differ only by experts whose probabilities are within NEAR_TIE of
    the k-th largest (in bf16: within NEAR_TIE_BF16 times it)."""
    k = a.numel()
    kth = float(torch.topk(probs_row, k).values[-1])
    lim = NEAR_TIE_BF16 * kth if bf16 else NEAR_TIE
    diff = set(a.tolist()) ^ set(b.tolist())
    return all(abs(float(probs_row[e]) - kth) <= lim for e in diff)


def flip_gate(probs_row: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              mcfg) -> float:
    """The largest router gate among the experts in one top-k set and not
    the other (gates from ``probs_row``, normalised over the top-k as the
    router does when ``router_norm_topk``)."""
    top = torch.topk(probs_row, a.numel()).values
    norm = float(top.sum()) if mcfg.router_norm_topk else 1.0
    diff = set(a.tolist()) ^ set(b.tolist())
    return max(float(probs_row[e]) / norm for e in diff)


def copy_caches(src, dst) -> None:
    """Overwrite ``dst``'s KV caches and positions with ``src``'s."""
    for a, b in zip(src["layers"], dst["layers"]):
        for key, t in a.items():
            b[key].copy_(t)
    dst["pos"].copy_(src["pos"])


def teacher_forced(eng, ref, prompts, toks, n_moe: int, dtype) -> None:
    """Both engines prefill the prompts and then read the kernel engine's
    tokens step by step; their logits must agree within LOGIT_TOL (in
    bf16 LOGIT_TOL_BF16) of the reference's largest, and their router
    choices (MoE layers) outside near-ties.

    In f32 each engine steps from its own caches, and a row whose router
    flipped at a near-tie is not compared after that step.  In bf16 the
    reference steps from a copy of the kernel engine's caches, so each
    step compares one step of both from the same state (bf16 steps do not
    pile up over the 32 steps), and a row whose router flipped at a
    near-tie is not compared at that step only, and only where a flipped
    expert's gate exceeds FLIP_GATE_BF16: with top-2 gates a flipped
    expert carries half the layer's output, with top-6 of 64 unnormalised
    ones a few percent, and 27 such layers flip near-ties in every row
    of most steps."""
    bf16 = dtype != torch.float32
    tol = LOGIT_TOL_BF16 if bf16 else LOGIT_TOL
    mcfg = eng.cfg.moe
    dev = eng.device
    B, NEW = toks.shape
    lk, ck = eng.prefill(prompts, NEW)
    lr, cr = ref.prefill(prompts, NEW)
    row_ok = np.ones(B, bool)
    worst = 0.0
    flips = skipped = 0

    def compare(step, a, b):
        nonlocal worst
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"step {step}: non-finite kernel-engine logits")
        for r in np.nonzero(row_ok)[0]:
            scale = float(b[r].abs().max())
            d = float((a[r] - b[r]).abs().max())
            worst = max(worst, d / max(scale, 1e-30))
            if d > tol * scale:
                fail(f"step {step} row {r}: max |dlogit| {d:.3e} vs "
                     f"max |logit| {scale:.3e}")

    compare("prefill", lk, lr)
    ref_tokens = torch.as_tensor(toks, device=dev)
    for t in range(NEW):
        if bf16:
            copy_caches(ck, cr)
            row_ok[:] = True
        ok = eng.step(ref_tokens[:, t], ck)
        orf = ref.step(ref_tokens[:, t], cr)
        ck, cr = ok.caches, orf.caches
        if n_moe:
            ta, tb = ok.trace.cpu(), orf.trace.cpu()
        for layer in range(n_moe):
            for r in range(B):
                a, b = ta[layer, r], tb[layer, r]
                if row_ok[r] and set(a.tolist()) != set(b.tolist()):
                    probs = orf.router_probs[layer, r].cpu()
                    if not near_tie(probs, a, b, bf16):
                        fail(f"step {t} layer {layer} row {r}: router "
                             f"top-k {a.tolist()} vs {b.tolist()}")
                    flips += 1
                    row_ok[r] = bf16 and flip_gate(probs, a, b, mcfg) <= \
                        FLIP_GATE_BF16
        skipped += int((~row_ok).sum())
        compare(t, ok.logits, orf.logits)
        if not row_ok.any():
            fail(f"step {t}: every row hit a router near-tie; nothing left "
                 "to compare")
    if bf16 and 2 * skipped > B * NEW:
        fail(f"router near-ties left {B * NEW - skipped} of {B * NEW} "
             "(row, step) pairs compared")
    log(f"  teacher-forced vs impl='ref' ({'bf16, each step from the '
        'kernel engine state' if bf16 else 'f32'}): max |dlogit| / max "
        f"|logit| = {worst:.3e} (limit {tol}); router near-tie flips "
        f"{flips}; (row, step) pairs not compared {skipped} of {B * NEW}; "
        f"rows compared to the end {int(row_ok.sum())}/{B}")


def check_generation(res, B, NEW, vocab) -> None:
    toks = res.tokens
    if toks.shape != (B, NEW) or not np.all((toks >= 0) & (toks < vocab)):
        fail(f"generated tokens malformed: shape {toks.shape}")
    if not np.all(np.isfinite(res.logprobs)):
        fail("non-finite log-probs")


def slice_phase(dev, dtype=torch.float32):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params)
    from repro_torch.serve.engine import ServeEngine
    cfg = slice_config()
    B, P, NEW = 4, 256, 32
    log(f"  weights, activations and KV cache in {dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
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
        f"prefill C = B*P = {B * P}), on the decode path "
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
    teacher_forced(eng, ref, prompts, toks, n_moe, dtype)
    return {"launches": launches, "eager_launches": sv["eager_launches"],
            "engine": eng,
            "stacks": stacks, "cfg": cfg_q, "profile": sv["profile"],
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW,
            "mma_launches": mma_launches, "cut": cfg, "prompts": prompts,
            "eager": sv["eager"]}


def serve_slice(dev, cfg_q, qparams, prompts, NEW, counters) -> dict:
    """A slice's main path: ``ServeEngine.generate`` with the decode graph,
    first a warm-up generate of the timed run's prompts and new tokens
    (so in the timed bucket; the one capture happens in it), then the
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
    warm = eng.generate(prompts, max_new=NEW)
    log(f"  decode graph capture: {warm.capture_s:.3f} s (eager warm-up "
        f"step, then capture of one decode step, in the warm-up generate "
        f"of the timed bucket; graphs {eng.num_graphs}: resident caches "
        f"{sorted(eng._caches)})")
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
    pg = profile_decode(eng, prompts, NEW, res.decode_s / NEW)
    pe = profile_decode(eager, prompts, NEW, eres.decode_s / NEW)
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
            "launches": launches, "eager_launches": eager_launches,
            "profile": {"graph": pg, "eager": pe}}


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
    hold positions 0..filled-1 and the rest are empty (-1).  ``filled``
    may be a list, one count per row: rows at their own positions, as
    ``serve``'s slots sit (each row's cur its last filled position).
    ``ring``: a ring cache that has wrapped, every slot written and its
    positions out of order (slot s holds the newest position p <= cur
    with p % S == s, cur = S + S // 3)."""
    q = torch.randn((B, H, hd), generator=gen, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    if isinstance(filled, list):
        f = torch.tensor(filled, dtype=torch.int32, device=dev)
        pos = torch.where(ar[None] < f[:, None], ar[None], -1).contiguous()
        cur = (f.clamp(min=1) - 1).contiguous()
    else:
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


def sdpa_call(q, k, v, pos, cur, ks, window=None):
    """The yardstick: one ``scaled_dot_product_attention`` call (GQA, an
    explicit (B, 1, 1, S) bool mask, with the window's bound where there
    is one) computing the same function, in the cache's float type; None
    for an int8 cache, which no single PyTorch call reads."""
    import torch.nn.functional as F
    if ks is not None:
        return None
    qs = q[:, :, None, :].to(k.dtype)
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window:
        valid &= pos > cur[:, None] - window
    mask = valid[:, None, None, :]
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


def flash_slice_timing(dev, gen, flush, sl, kind="f32") -> dict:
    """Flash-decode at a slice's decode shape (its cache bucket, the
    prompt and new tokens valid, a ``kind`` cache) beside its plain
    version, SDPA and its bound; the ``kernels`` line's entry."""
    cfg, B = sl["cfg"], sl["B"]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    filled = sl["P"] + sl["NEW"]
    S = 1 << filled.bit_length()
    args = flash_inputs(gen, dev, B, H, KVH, hd, S, filled, kind)
    return flash_timed(args, None, kind, flush,
                       f"flash_decode B={B} H={H} KVH={KVH} (G={H // KVH}) "
                       f"hd={hd} S={S} valid={filled} {kind}")


def flash_timed(args, window, kind: str, flush, what: str) -> dict:
    """Flash-decode on ``args`` (with ``window``) beside its plain
    version, SDPA and its bound, held to both; the ``kernels`` line's
    entry."""
    from repro_torch.kernels import decode_attention as fd
    q, k, v, pos, cur, _, _ = args
    kt = time_ms(lambda: fd.flash_decode_attention(
        *args, window=window, require_kernel=True), 20, flush)
    pt = time_ms(lambda: fd.flash_decode_attention_plain(
        *args, window=window), 20, flush)
    sd = sdpa_call(q, k, v, pos, cur, None, window)
    lt = time_ms(sd, 20, flush)
    got = fd.flash_decode_attention(*args, window=window, require_kernel=True)
    # SDPA runs in the cache's type: in bf16 its probabilities and output
    # round to 8 bits, so the kernel (f32 inside) is held to the plain
    # version there and to SDPA only within bf16's step
    tol = 1e-4 if kind == "f32" else 2e-2
    allclose_report("flash_decode vs SDPA", got, sd()[:, :, 0].float(),
                    atol=tol, rtol=tol)
    allclose_report("flash_decode vs plain", got,
                    fd.flash_decode_attention_plain(*args, window=window),
                    **DECODE_TOL)
    bms, by = bound(*flash_bytes_ops(q, k, pos, cur, None, window))
    log(f"  {what}: kernel {_fmt(kt)}; plain {_fmt(pt)}; SDPA "
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


def paged_bytes_ops(args, flat):
    """Least bytes and operations of one paged flash-decode call (``args``;
    ``flat``: its gathered view): ``flash_bytes_ops`` of the view, with
    the positions of the mapped pages and the block table read in place
    of one position per logical slot."""
    q, k, _, _, block, cur, ks, _ = args
    nb, ops = flash_bytes_ops(q, flat[1], flat[3], cur, ks)
    mapped = int((block >= 0).sum()) * k.shape[1]
    return nb - 4 * flat[3].numel() + 4 * mapped + 4 * block.numel(), ops


def flash_paged_timing(dev, gen, flush) -> dict:
    """Flash-decode's block-table mode at Mixtral's shape (B 4, H 32, KVH
    8, hd 128, f32, page 16, each row's pages in random order) at S 512
    (288 valid) and S 32768 (all valid): the paged call, the contiguous
    call on the same rows at the same S (the gathered view), and gather +
    contiguous kernel, beside the byte bound of what the paged call must
    read.  Returns the kernels line's paged keys."""
    from repro_torch.kernels import decode_attention as fd
    out = {}
    for S, filled in ((512, 288), (32768, 32768)):
        args = paged_flash_inputs(gen, dev, 4, 32, 8, 128, 16, S // 16,
                                  "f32", fills=[filled] * 4)
        flat = gathered(args)
        pt = time_ms(lambda: fd.flash_decode_attention_paged(
            *args, require_kernel=True), 10, flush)
        ct = time_ms(lambda: fd.flash_decode_attention(
            *flat, require_kernel=True), 10, flush)
        gt = time_ms(lambda: fd.flash_decode_attention(
            *gathered(args), require_kernel=True), 10, flush)
        plt = time_ms(lambda: fd.flash_decode_attention_paged_plain(*args),
                      10, flush)
        got = fd.flash_decode_attention_paged(*args, require_kernel=True)
        if not torch.equal(got, fd.flash_decode_attention(
                *flat, require_kernel=True)):
            fail(f"flash_decode paged S={S}: differs from the contiguous "
                 "call on the gathered view")
        nb, ops = paged_bytes_ops(args, flat)
        bms, by = bound(nb, ops)
        ms = _ms(f"flash_decode paged S={S}", pt)
        log(f"  flash_decode paged B=4 H=32 KVH=8 hd=128 page=16 S={S} "
            f"valid={filled} f32: paged {_fmt(pt)}, {nb / ms / 1e6:.1f} "
            f"GB/s ({100 * bms / ms:.1f}% of the bound); contiguous at the "
            f"same S {_fmt(ct)}; gather + kernel {_fmt(gt)}; plain route "
            f"(gather + plain version) {_fmt(plt)}; bound {bms:.4f} ms "
            f"({by}; {nb / 1e6:.2f} MB)")
        keys = dict(ms=ms, bound_ms=bms, gather_ms=_ms("gather", gt),
                    contiguous_ms=_ms("contiguous", ct),
                    plain_ms=_ms("paged plain", plt))
        pre = "paged_" if S == 512 else "paged_long_"
        out.update({pre + k: v for k, v in keys.items()})
        del args, flat, got
        torch.cuda.empty_cache()
    return out


def multi_bytes_ops(q, k, pos, cur, ks):
    """Least bytes and operations of one multi-query flash-decode call,
    q (B, Q, H, hd) at cur (B, Q): the K and V rows (and int8 scales) of
    the slots valid for any of a row's queries read once, positions, cur
    and q read once, the output written once; per query, valid slot and
    query head, hd multiply-adds for the score and hd for the value sum."""
    B, Q, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= cur[:, :, None])
    union, per = int(valid.any(1).sum()), int(valid.sum())
    row = hd * k.element_size() + (0 if ks is None else 2)
    nb = 2 * union * KVH * row + 4 * B * S + 4 * B * Q + 8 * B * Q * H * hd
    return nb, 4 * per * H * hd


def sdpa_multi_call(q, k, v, pos, cur, ks):
    """The multi-query yardstick: one ``scaled_dot_product_attention`` call
    with an explicit (B, 1, Q, S) mask over a contiguous cache, in its
    float type; None for an int8 cache."""
    import torch.nn.functional as F
    if ks is not None:
        return None
    qs = q.transpose(1, 2).to(k.dtype)                 # (B, H, Q, hd)
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((pos[:, None, :] >= 0)
            & (pos[:, None, :] <= cur[:, :, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(
        qs, kT, vT, attn_mask=mask, scale=1.0, enable_gqa=True)


def flash_multi_timing(dev, gen, flush) -> dict:
    """The multi-query mode at Q 4 (a verify round of k 3), Mixtral's
    shape (B 4, H 32, KVH 8, f32) and DeepSeek-MoE's (H 16, KVH 16, bf16),
    hd 128, rows at position 288 of S 512 and every slot valid at S 32768,
    contiguous and paged (page 16): the call beside Q single-query calls
    (one L2 flush before the Q), its byte bound, the plain version and
    SDPA with an explicit mask over the contiguous (for paged: the
    gathered) cache.  Returns the ``kernels`` line's multi-query keys."""
    from repro_torch.kernels import decode_attention as fd
    out = {}
    nq = 4
    for model, H, KVH, kind in (("mixtral", 32, 8, "f32"),
                                ("deepseek", 16, 16, "bf16")):
        for S, filled in ((512, 288), (32768, 32768)):
            for paged in (False, True):
                if paged:
                    args = paged_flash_inputs(gen, dev, 4, H, KVH, 128, 16,
                                              S // 16, kind, [filled] * 4)
                    flat = gathered(args)
                    q, cur = args[0], args[5]
                    call = fd.flash_decode_attention_paged
                    plain = fd.flash_decode_attention_paged_plain

                    def with_q(qq, cc, a=args):
                        return (qq,) + a[1:5] + (cc,) + a[6:]
                else:
                    args = flash_inputs(gen, dev, 4, H, KVH, 128, S, filled,
                                        kind)
                    flat = args
                    q, cur = args[0], args[4]
                    call = fd.flash_decode_attention
                    plain = fd.flash_decode_attention_plain

                    def with_q(qq, cc, a=args):
                        return (qq,) + a[1:4] + (cc,) + a[5:]
                qm, curm = multi_queries(gen, q, cur, nq)
                full = with_q(qm, curm)
                parts = [with_q(qm[:, i].contiguous(),
                                curm[:, i].contiguous()) for i in range(nq)]

                def singles(parts=parts, call=call):
                    for a in parts:
                        call(*a, require_kernel=True)
                mt = time_ms(lambda: call(*full, require_kernel=True), 10,
                             flush)
                st = time_ms(singles, 10, flush)
                pt = time_ms(lambda: plain(*full), 5, flush)
                sd = sdpa_multi_call(qm, flat[1], flat[2], flat[3], curm,
                                     flat[5])
                lt = time_ms(sd, 10, flush)
                got = call(*full, require_kernel=True)
                allclose_report("flash_decode multi-query vs SDPA", got,
                                sd().transpose(1, 2).float(),
                                atol=1e-4 if kind == "f32" else 2e-2,
                                rtol=1e-4 if kind == "f32" else 2e-2)
                nb, ops = multi_bytes_ops(qm, flat[1], flat[3], curm, flat[5])
                if paged:
                    mapped = int((args[4] >= 0).sum()) * 16
                    nb += 4 * mapped + 4 * args[4].numel() - 4 * 4 * S
                bms, by = bound(nb, ops)
                name = (f"flash_decode multi-query {model} B=4 H={H} "
                        f"KVH={KVH} hd=128 S={S} valid={filled} {kind} "
                        f"Q={nq} " + ("paged page=16" if paged
                                      else "contiguous"))
                ms = _ms(name, mt)
                log(f"  {name}: kernel {_fmt(mt)}, {nb / ms / 1e6:.1f} GB/s "
                    f"({100 * bms / ms:.1f}% of the bound); {nq} "
                    f"single-query calls {_fmt(st)}; plain {_fmt(pt)}; SDPA "
                    f"(explicit mask, {'gathered' if paged else 'the'} "
                    f"cache) {_fmt(lt)}; bound {bms:.4f} ms ({by}; "
                    f"{nb / 1e6:.2f} MB)")
                pre = (("" if model == "mixtral" else "deepseek_")
                       + "multi_" + ("paged_" if paged else "")
                       + ("long_" if S > 512 else ""))
                out.update({pre + "ms": ms,
                            pre + "singles_ms": _ms(name + " singles", st),
                            pre + "bound_ms": bms,
                            pre + "plain_ms": _ms(name + " plain", pt),
                            pre + "library_ms": _ms(name + " SDPA", lt)})
                del args, flat, full, parts, got
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
        log(f"  fused crossover {proj} C={T} rows={rows.tolist()}: decode "
            f"kernel {out[T]['simt']:.4f} ms, prefill tile "
            f"{out[T]['mma']:.4f} ms on the device (the wrapper takes "
            f"{qm.fused_path(T)}; FUSED_MMA_MIN_C {qm.FUSED_MMA_MIN_C})")
        del xe, me, ge, args
    return out


def rank_space_bytes(st, me, cap, ranks) -> int:
    """Least bytes of a fused call's rank-space work on these inputs: the
    int8 U and V rows of each compensated expert's live ranks (below
    min(pad_rank, rank cap, ranks[e])), their f32 scales, and xu (f32,
    one row per compensated slot), each once."""
    E, K, N = st.shape
    n_comp = (me != 0).sum(dim=1).tolist()
    lim = st.pad_rank if cap is None else min(st.pad_rank, int(cap))
    nb = 0
    for e in range(E):
        r = min(lim, int(ranks[e]))
        if n_comp[e] and r > 0:
            nb += r * (K + N) + 8 * r + 4 * n_comp[e] * r
    return nb


def kwalk_bytes(st, C: int, rows) -> int:
    """Least bytes of a fused call's K walk on these inputs: the planes and
    f32 scale/zero of the experts that hold tokens, their occupied x rows
    (f32) and the (E, C, N) f32 output, each once."""
    E, K, N = st.shape
    occ = rows.tolist()
    per_expert = (sum(p[0].numel() for p in st.planes)
                  + 4 * (st.scale[0].numel() + st.zero[0].numel()))
    return 4 * E * C * N + sum(per_expert + 4 * o * K for o in occ if o > 0)


def fused_decode_parts(dev, gen, flush, st, cfg, proj: str, label: str,
                       C: int) -> dict:
    """The parts of one fused call at a decode capacity C (the decode step
    at C = batch, a verify round at C = batch * (k + 1)) on the decode
    path, on dispatch-like inputs and on the same inputs with the stack's
    pad_rank forced onto a compensated expert: the whole call, the
    rank-space pre-pass alone (and with rank cap 0: its grid with every
    tile dead), the main kernel, and the main kernel with rank cap 0 (the
    K walk alone, no epilogue; the difference is the epilogue), beside
    the rank-space byte bound and the K walk's (``kwalk_bytes``).
    Returns {case: {part: device ms, ...}}."""
    from repro_torch.kernels import quant_matmul as qm
    E, K, N = st.shape
    kw = dict(bits=st.bits, group_size=st.group_size)
    eb, ranks = st.meta_tensors()
    xe, me, ge, rows = dispatch_like(gen, dev, E, C, K, cfg.moe.top_k,
                                     cfg.moe.quant.top_n_restore)
    ge = ge if proj == "w2" else None
    comp = torch.nonzero(me.sum(dim=1) > 0)[:, 0].tolist()
    rk = [int(r) for r in st.ranks]
    forced = list(rk)
    if comp and max(rk[e] for e in comp) < st.pad_rank:
        forced[comp[0]] = st.pad_rank
    cap0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = {}
    for case, rlist in (("dispatch", rk), ("forced", forced)):
        rt = torch.tensor(rlist, dtype=torch.int32, device=dev)
        args = (xe, st.planes, st.scale, st.zero, st.u, st.u_scale, st.v,
                st.v_scale, me, ge, None, eb, rt, rows)
        dead = args[:10] + (cap0,) + args[11:]
        idle = dead[:13] + (torch.zeros_like(rows),)
        t = {"call": time_ms(lambda: qm.fused_expert_matmul(
                *args, require_kernel=True, **kw), 10, flush),
             "prepass": time_ms(lambda: qm._fused_parts(
                 ("prepass",), *args, **kw), 10, flush),
             "prepass cap 0": time_ms(lambda: qm._fused_parts(
                 ("prepass",), *dead, **kw), 10, flush),
             "main": time_ms(lambda: qm._fused_parts(
                 ("simt",), *args, **kw), 10, flush),
             "main cap 0": time_ms(lambda: qm._fused_parts(
                 ("simt",), *dead, **kw), 10, flush),
             "main idle": time_ms(lambda: qm._fused_parts(
                 ("simt",), *idle, **kw), 10, flush)}
        ms = {k: _ms(f"{label} fused {proj} C={C} {case} {k}", v)
              for k, v in t.items()}
        ms["epilogue"] = ms["main"] - ms["main cap 0"]
        nb = rank_space_bytes(st, me, None, rlist)
        ms["rank bound"] = nb / HBM_BYTES_PER_S * 1e3
        kb = kwalk_bytes(st, C, rows)
        ms["kwalk bound"] = kb / HBM_BYTES_PER_S * 1e3
        live = sorted({rlist[e] for e in comp if rlist[e] > 0},
                      reverse=True)
        log(f"  {label} fused {proj} decode parts C={C} {case}: compensated "
            f"experts {len(comp)}, their live ranks {live}, live experts "
            f"{int((rows > 0).sum())}; ms on the device: call "
            f"{ms['call']:.4f}, pre-pass {ms['prepass']:.4f} (every tile "
            f"dead {ms['prepass cap 0']:.4f}), decode main kernel "
            f"{ms['main']:.4f}, with rank cap 0 (K walk) "
            f"{ms['main cap 0']:.4f} against its byte bound "
            f"{ms['kwalk bound']:.4f} ({kb / 1e6:.3f} MB; every expert "
            f"idle {ms['main idle']:.4f}), so epilogue "
            f"{ms['epilogue']:.4f}; rank-space bound {ms['rank bound']:.6f} "
            f"({nb / 1e6:.3f} MB); pre-pass grid "
            f"{qm.xu_geometry(E, C, K, st.pad_rank)}")
        out[case] = ms
    del xe, me, ge, args, dead, idle
    return out


def fused_timing(dev, gen, flush, sl, label: str, crossover: bool):
    """Kernel 1 on a slice's first MoE layer's w1 and w2 stacks on
    dispatch-like inputs (top-k of E experts, the first top-n
    compensated, exact capacity): at decode (C = B tokens) and at prefill
    (C = B*P), each beside its plain version and bounds; at decode (C = B
    and a verify round's C = 4B) the parts of the call on the decode
    path (``fused_decode_parts``); at prefill both main-kernel paths and
    the parts of the call (rank-space pre-pass, main kernel).  Returns
    the ``kernels`` line's fused entry (w1; the decode parts of w2 with
    a pad_rank expert compensated under ``decode_forced_*``) and, with
    ``crossover``, both paths at smaller C per projection."""
    from repro_torch.kernels import quant_matmul as qm
    cfg = sl["cfg"]
    B = sl["B"]
    E = cfg.moe.num_experts
    entry, cross = {}, {}
    for proj in ("w1", "w2"):
        st = sl["stacks"][0][proj]
        K = st.shape[1]
        kw = dict(bits=st.bits, group_size=st.group_size)
        eb, ranks = st.meta_tensors()
        for C in (B, 4 * B):
            dparts = fused_decode_parts(dev, gen, flush, st, cfg, proj,
                                        label, C)
            if C != B:
                continue
            case, pre = (("dispatch", "decode_") if proj == "w1" else
                         ("forced", "decode_forced_"))
            entry.update({pre + "prepass_ms": dparts[case]["prepass"],
                          pre + "epilogue_ms": dparts[case]["epilogue"],
                          pre + "rank_bound_ms": dparts[case]["rank bound"]})
            if proj == "w1":
                entry.update(
                    decode_kwalk_ms=dparts[case]["main cap 0"],
                    decode_kwalk_bound_ms=dparts[case]["kwalk bound"])
            if proj == "w2":
                entry["decode_forced_ms"] = dparts[case]["call"]
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
            log(f"  {label} fused {proj} E={E} C={C} K={K} N={st.shape[2]} "
                f"bits={st.bits} pad_rank={st.pad_rank} live experts "
                f"{int((rows > 0).sum())} rows={rows.tolist()} "
                f"path={qm.fused_path(C)}: kernel {_fmt(kt)}; plain "
                f"{_fmt(pt)}; bound f32 CUDA cores {bms:.4f} ms ({by}; "
                f"{nb / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), bf16 tensor "
                f"cores x2 {tms:.4f} ms ({tby})")
            if C == B:
                if proj == "w1":
                    entry.update(
                        ms=_ms(f"{label} fused kernel", kt),
                        plain_ms=_ms(f"{label} fused plain", pt),
                        bound_ms=bms, bound_by=by)
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
            log(f"  {label} fused {proj} C={C} parts, ms on the device: "
                f"rank-space pre-pass {parts['prepass']['device']:.4f} "
                f"(grid {qm.xu_geometry(E, C, K, st.pad_rank)}); "
                f"decode main "
                f"kernel {parts['simt main']['device']:.4f} (call "
                f"{parts['simt all']['device']:.4f}); tensor-core main "
                f"kernel {parts['mma main']['device']:.4f} (call "
                f"{parts['mma all']['device']:.4f}; main kernel with rank "
                f"cap 0 {parts['mma main cap 0']['device']:.4f}, with every "
                f"slot empty {parts['mma main rows 0']['device']:.4f}: "
                f"{4 * E * C * st.shape[2] / 1e6:.1f} MB of zeros)")
            if proj == "w1":
                entry.update(
                    prefill_ms=_ms(f"{label} fused prefill kernel", kt),
                    prefill_plain_ms=_ms(f"{label} fused prefill plain",
                                         pt),
                    prefill_bound_ms=tms, prefill_bound_by=tby,
                    prefill_bound_f32_ms=bms,
                    prefill_simt_ms=_ms(f"{label} fused prefill decode "
                                        "path", parts["simt all"]),
                    prefill_prepass_ms=_ms(f"{label} fused prefill pre-pass",
                                           parts["prepass"]))
            del xe, me, ge, args
        if crossover:
            cross[proj] = fused_crossover(dev, gen, st, cfg, flush, proj)
    return entry, cross


def timing_phase(dev, sl):
    from repro_torch.kernels import decode_attention as fd
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    table = {}
    # top-n = 1 of top-2 -> about half the slots compensated
    entry, cross = fused_timing(dev, gen, flush, sl, "mixtral", True)
    table["fused_expert_matmul"] = dict(entry, library_ms=None)
    for T, t1 in cross["w1"].items():
        t2 = cross["w2"][T]
        layer = {p: 2 * t1[p] + t2[p] for p in t1}
        log(f"  fused crossover per MoE layer (w1 + w3 + w2) C={T}: decode "
            f"kernel {layer['simt']:.4f} ms, prefill tile {layer['mma']:.4f}"
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
    table["flash_decode_attention"].update(flash_paged_timing(dev, gen,
                                                              flush))
    table["flash_decode_attention"].update(flash_multi_timing(dev, gen,
                                                              flush))
    # RecurrentGemma-9B's local layers: G 16 (MQA) over the full ring of
    # its window, bf16 as phase 14 serves it, and f32
    for kind in ("bf16", "f32"):
        timed = flash_window_timing(dev, gen, flush, 4, 16, 1, 256, 2048,
                                    kind)
        table["flash_decode_attention"].update(
            {f"recurrentgemma_9b_window_{kind}_{k}": v
             for k, v in timed.items() if k != "bound_by"})
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


def dense_phase(dev, dtype=torch.float32):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params)
    from repro_torch.serve.engine import ServeEngine
    cfg = dense_config()
    B, P, NEW = 4, 256, 32
    log(f"  weights, activations and KV cache in {dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
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
    teacher_forced(eng, ref, prompts, res.tokens, 0, dtype)
    return {"launches": launches, "eager_launches": sv["eager_launches"],
            "stacks": stacks, "cfg": cfg_q, "profile": sv["profile"],
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW}


# ---------------------------------------------------------------------------
# phase 7: DeepSeek-MoE-16B in bf16 (dense layer 0, shared experts, 64
# experts top-6, top-n 3)
# ---------------------------------------------------------------------------

def deepseek_config():
    from repro_torch.registry import get_config
    cfg = get_config("deepseek-moe-16b")
    m, q = cfg.moe, cfg.moe.quant
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}"
        f"/{cfg.num_kv_heads} kv (G {cfg.q_per_kv}), head_dim "
        f"{cfg.head_dim}, dense layer 0 d_ff {cfg.d_ff}, experts "
        f"{m.num_experts} top-{m.top_k}, d_expert {m.d_expert}, shared "
        f"{m.num_shared_experts} x {m.d_shared}, router_norm_topk "
        f"{m.router_norm_topk}, vocab {cfg.vocab_size}, tied embeddings "
        f"{cfg.tie_embeddings}, bits {q.bits}, group {q.group_size}, "
        f"rank_budget {q.rank_budget}, top_n {q.top_n_restore}")
    log(f"  depth {cfg.num_layers} layers, as published (no cut)")
    return cfg


def deepseek_phase(dev):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params, layer_specs)
    from repro_torch.serve.engine import ServeEngine
    cfg = deepseek_config()
    B, P, NEW = 4, 256, 32
    dtype = torch.bfloat16
    log(f"  weights, activations and KV cache in {dtype}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    raw_gib = torch.cuda.memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    qparams, cfg_q, stacks = compress_moe_params(params, cfg)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    s = stacks[0]["w1"]
    stack_gib = sum(t.numel() * t.element_size() for st in stacks
                    for x in st.values()
                    for t in (*x.planes, x.scale, x.zero, x.u, x.v,
                              x.u_scale, x.v_scale)) / 2**30
    log(f"  init {t_init:.2f} s ({raw_gib:.2f} GiB of bf16 params); "
        f"compression {t_comp:.2f} s ({len(stacks)} MoE layers x 3 stacks "
        f"of {cfg.moe.num_experts} experts; dense layer 0 and the shared "
        f"experts uncompressed); stacks {stack_gib:.2f} GiB; device memory "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB after "
        f"compression, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        f" GiB")
    log(f"  layer-0 w1 ranks {list(s.ranks)}, pad_rank {s.pad_rank}")
    specs = layer_specs(cfg_q)
    if specs[0].ffn != "dense" or "shared" not in qparams["layers"][1]["moe"]:
        fail("DeepSeek-MoE lost its dense layer 0 or its shared experts")

    prompts = np.random.default_rng(2).integers(
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
    simt_launches = launches["fused_expert_matmul"] - mma_launches
    log(f"  fused_expert_matmul launches on the tensor-core path "
        f"{mma_launches} (prefill C = B*P = {B * P}), on the decode path "
        f"{simt_launches}")
    if mma_launches <= 0 or simt_launches <= 0:
        fail(f"kernel 1 did not run on both of its paths: {mma_launches} "
             f"prefill-tile and {simt_launches} decode-kernel launches")
    if launches["flash_decode_attention"] <= 0:
        fail(f"flash-decode was never launched: {launches}")
    check_generation(res, B, NEW, cfg.vocab_size)
    n_moe = len(stacks)
    if res.router_trace.shape != (NEW, n_moe, B, cfg.moe.top_k):
        fail(f"router trace shape {res.router_trace.shape}, expected "
             f"{(NEW, n_moe, B, cfg.moe.top_k)}")
    ref = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="ref",
                      device=dev)
    teacher_forced(eng, ref, prompts, res.tokens, n_moe, dtype)
    return {"launches": launches, "eager_launches": sv["eager_launches"],
            "engine": eng,
            "stacks": stacks, "cfg": cfg_q, "profile": sv["profile"],
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW,
            "mma_launches": mma_launches}


def deepseek_timing(dev, sl) -> dict:
    """Kernel 1 at DeepSeek-MoE-16B's shapes (first MoE layer's w1 and w2:
    E 64, top-6 of 64 with top-n 3, pad_rank as compressed) at decode and
    prefill, and flash-decode at its decode shape (G 1, bf16 cache)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    entry, _ = fused_timing(dev, gen, flush, sl, "deepseek", False)
    flash = flash_slice_timing(dev, gen, flush, sl, "bf16")
    return {"fused_expert_matmul": {f"deepseek_{k}": v
                                    for k, v in entry.items()},
            "flash_decode_attention": {f"deepseek_{k}": v
                                       for k, v in flash.items()
                                       if k != "bound_by"}}


def qmm_bytes_ops(M, K, N, planes, R):
    """Least bytes and operations of one compensated quant_matmul: x, the
    packed planes, f32 scale/zero at g64, the int8 U/V of rank R and
    their scales, the mask, each read once; the output written once."""
    nb = (4 * M * K + sum(p.numel() for p in planes) + 2 * 4 * (K // 64) * N
          + R * (K + N) + 8 * R + 4 * M + 4 * M * N)
    return nb, 2 * M * K * N + 2 * M * R * (K + N)


def qmm_crossover(dev, gen, st, qt, flush, proj):
    """One projection at small M on both kernel paths (the decode kernel
    on the CUDA cores, the tensor-core tile): {M: {path: device ms}}, the
    timings the path threshold MMA_MIN_M rests on."""
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
        log(f"  crossover {proj} M={M}: decode kernel "
            f"{out[M]['splitk']:.4f} ms, tensor cores {out[M]['mma']:.4f} "
            f"ms on the device (the "
            f"wrapper takes {qm.qmm_path(M)}; MMA_MIN_M {qm.MMA_MIN_M})")
    return out


def qmm_one_launch(fn, flush, what: str) -> None:
    """Fail unless a call of ``fn`` (quant_matmul below MMA_MIN_M) runs
    one kernel on the card, the decode kernel: the profiler's kernels by
    name over 20 calls."""
    calls = 20
    by = kernels_by_name(fn, flush, calls)
    log(f"  quant_matmul {what} call's kernels (profiler, {calls} calls): "
        + "; ".join(f"{n[:60]} x{c} {ms:.4f} ms" for n, (ms, c)
                    in by.items()))
    if len(by) != 1 or "qmm_decode_kernel" not in next(iter(by)):
        fail(f"a {what} quant_matmul at decode is not one launch of the "
             f"decode kernel: {sorted(by)}")


def dense_timing(dev, sl):
    """Kernel 3 on the dense slice's layer-0 stacks at decode (M = B) and
    prefill (M = B*P), every token compensated, beside its plain version,
    its bounds (f32 CUDA cores and, for the tensor-core path, bf16 tensor
    cores), and (context only) cuBLAS ``x @ W`` on the dequantized f32
    weight; at decode the cluster geometry, w1's call without
    compensation (the K walk alone) and the check that a call is one
    kernel; w1 and w2 on both paths at small M (the path threshold); and
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
            if qm.qmm_path(M) == "splitk":
                cs, kch = qm.decode_splits(dev, M, K, N, st.pad_rank,
                                           qt.bits)
                tiles = -(-M // qm.token_tile(M)) * -(-N // qm.QMM_BN)
                clusters, per_sm = qm.decode_occupancy(
                    dev, qt.bits, M, st.pad_rank, cs)
                geo = (f"decode kernel: {tiles} clusters of {cs} blocks x "
                       f"{kch} pack blocks ({kch / qm.QMM_WARPS:.2f} per "
                       f"warp), {clusters} clusters resident at once, "
                       f"{per_sm} blocks per SM")
            else:
                geo = "tensor cores"
            log(f"  quant_matmul {proj} M={M} K={K} N={N} bits={qt.bits} "
                f"R={st.pad_rank} path={qm.qmm_path(M)} ({geo}): "
                f"kernel {_fmt(kt)}; plain {_fmt(pt)}; dense f32 cuBLAS "
                f"x@W (16x the weight bytes, context) {_fmt(dt)}; bound "
                f"f32 CUDA cores {bms:.4f} ms ({by}; {nb / 1e6:.2f} MB, "
                f"{ops_n / 1e9:.3f} GFLOP), bf16 tensor cores x2 "
                f"{tms:.4f} ms ({tby})")
            if proj == "w1" and M == B:
                wt = time_ms(lambda: qm.quant_matmul(
                    *args[:4], require_kernel=True, **kw), 20, flush)
                log(f"  quant_matmul {proj} M={M} without compensation "
                    f"(the K walk alone): {_fmt(wt)}")
                qmm_one_launch(lambda: qm.quant_matmul(
                    *args, require_kernel=True, **kw), flush, "compensated")
                qmm_one_launch(lambda: qm.quant_matmul(
                    *args[:4], require_kernel=True, **kw), flush,
                    "uncompensated")
                table["quant_matmul"] = dict(
                    ms=_ms("quant_matmul kernel", kt),
                    plain_ms=_ms("quant_matmul plain", pt), bound_ms=bms,
                    bound_by=by, library_ms=None,
                    walk_ms=_ms("quant_matmul walk", wt))
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
        log(f"  crossover per layer (w1 + w3 + w2) M={M}: decode kernel "
            f"{layer['splitk']:.4f} ms, tensor cores {layer['mma']:.4f} ms")
    flash_slice_timing(dev, gen, flush, sl)
    return table


# ---------------------------------------------------------------------------
# phase 8: continuous-batching serve() with byte-metered expert offload and
# the bandwidth controller
# ---------------------------------------------------------------------------

def serve_line(name: str, st, idle=None) -> None:
    """Log one ``serve`` run's end-to-end numbers."""
    rep = st.offload_report
    tok = max(rep["tokens"], 1)
    ttft, lat = st.ttft_percentiles(), st.latency_percentiles()
    log(f"  {name}: {st.generated_tokens} tokens in {st.total_s:.3f} s = "
        f"{st.tokens_per_s:.2f} tok/s; decode {st.decode_s:.3f} s in "
        f"{st.chunks} chunks of {st.chunk} steps = "
        f"{st.generated_tokens / st.decode_s:.2f} tok/s (graph capture "
        f"{st.capture_s:.3f} s of it); prefill "
        f"{st.prefill_s:.3f} s ({st.prefill_tokens} padded tokens); TTFT "
        f"p50/p95 {ttft[50.0] * 1e3:.1f}/{ttft[95.0] * 1e3:.1f} ms; latency"
        f" p50/p95 {lat[50.0] * 1e3:.1f}/{lat[95.0] * 1e3:.1f} ms")
    log(f"  {name}: {rep['bytes_per_token']:.1f} wire bytes/token (demand "
        f"{rep['demand_bytes'] / tok:.1f}, compensator "
        f"{rep['compensator_bytes'] / tok:.1f}, prefetch "
        f"{rep['prefetch_bytes'] / tok:.1f} of which wasted "
        f"{rep['wasted_prefetch_bytes'] / tok:.1f}); hit rate "
        f"{rep['hit_rate']:.4f}; prefetch accuracy "
        f"{rep['prefetch_accuracy']:.4f}; metering "
        f"{st.meter_s * 1e3 / st.chunks:.2f} host ms/chunk ({st.meter_s:.3f}"
        f" s of {st.total_s:.3f})"
        + ("" if idle is None else f"; card idle share {idle:.3f}"))


def same_serve(a, b, plans: bool = True) -> bool:
    """Tokens, per-request and aggregate traces, offload reports and
    per-request bytes identical, and (``plans``) plan traces."""
    return (all(np.array_equal(x.tokens, y.tokens)
                and np.array_equal(x.trace, y.trace)
                and x.offload_bytes == y.offload_bytes
                for x, y in zip(a.results, b.results))
            and np.array_equal(a.router_trace, b.router_trace)
            and a.offload_report == b.offload_report
            and (not plans or (a.plan_trace is None) == (b.plan_trace is None)
                 and (a.plan_trace is None
                      or np.array_equal(a.plan_trace, b.plan_trace))))


def device_busy(fn):
    """``fn()`` under the profiler, device activity only.  Returns (its
    result, ms of the window in which the card ran anything: the union of
    every kernel's, copy's and set's span, since a copy stream may run
    beside the compute stream; ms of H2D copies; device ops; wall s with
    the profiler on).  Reads the profiler's raw events: a serve run's
    ~10^5 kernels are too many for its per-event Python
    post-processing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not evs:
        fail("the profiler saw no device activity in a serve run")
    busy, end = 0, None
    for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in evs):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    h2d = sum(e.duration_ns() for e in evs if "HtoD" in e.name())
    return res, busy / 1e6, h2d / 1e6, len(evs), wall


def check_bytes(name: str, st) -> None:
    rep = st.offload_report
    billed = sum(r.offload_bytes for r in st.results)
    if billed != rep["demand_bytes"] + rep["compensator_bytes"]:
        fail(f"{name}: per-request offload bytes sum to {billed}, demand + "
             f"compensator {rep['demand_bytes'] + rep['compensator_bytes']}")
    if not all(np.all(np.isfinite(r.logprobs)) for r in st.results):
        fail(f"{name}: non-finite log-probs")


def tail_bytes_per_token(ctrl) -> float:
    """Wire bytes/token over the last half of a controlled run's chunks
    (the controller's per-chunk records)."""
    h = ctrl.history[len(ctrl.history) // 2:]
    return (sum(r.bytes_per_token * r.tokens for r in h)
            / max(sum(r.tokens for r in h), 1))


def serve_divergence(eng, prompts, gen, sv) -> int:
    """Rows where ``serve`` (admissions prefilled at batch 1: kernel 1's
    decode kernel) and ``generate`` (batch-4 prefill: its prefill tile)
    part: each row's first differing step must be a near-tie of
    ``generate``'s f32 state, the token one of its logits (softmax within
    NEAR_TIE), the routing one of its router (``near_tie``).  Checked
    teacher-forced on ``generate``'s tokens from a batch-4 prefill.
    Returns the number of rows that part."""
    toks = np.stack([r.tokens for r in sv.results])
    first = {}
    for r in range(toks.shape[0]):
        tok_d = np.nonzero(toks[r] != gen.tokens[r])[0]
        tr_d = np.nonzero((sv.router_trace[:, :, r] !=
                           gen.router_trace[:, :, r]).any(axis=(1, 2)))[0]
        steps = [int(x[0]) for x in (tok_d, tr_d) if x.size]
        if steps:
            first[r] = min(steps)
    if not first:
        return 0
    logits, caches = eng.prefill(prompts, gen.tokens.shape[1])
    ref = torch.as_tensor(gen.tokens, device=eng.device)
    for t in range(max(first.values()) + 1):
        probs = torch.softmax(logits.float(), dim=-1).cpu()
        out = eng.step(ref[:, t], caches)
        for r, ft in first.items():
            if ft != t:
                continue
            a = torch.tensor([int(gen.tokens[r, t])])
            b = torch.tensor([int(toks[r, t])])
            if a != b and not near_tie(probs[r], a, b):
                fail(f"serve vs generate row {r} step {t}: token {int(b)} "
                     f"against {int(a)} outside a near-tie")
            for layer in range(gen.router_trace.shape[1]):
                ga = torch.as_tensor(gen.router_trace[t, layer, r])
                sb = torch.as_tensor(sv.router_trace[t, layer, r])
                if a == b and set(ga.tolist()) != set(sb.tolist()) and \
                        not near_tie(out.router_probs[layer, r].cpu(), ga,
                                     sb):
                    fail(f"serve vs generate row {r} step {t} layer {layer}:"
                         f" router {sb.tolist()} against {ga.tolist()} "
                         "outside a near-tie")
        logits = out.logits
    log(f"  serve vs generate: rows part at a near-tie at steps {first}")
    return len(first)


def serve_mixtral(dev, mx, counters) -> dict:
    """Phase 3's compressed 2-layer Mixtral-8x7B (f32): ``serve`` against
    ``generate`` on phase 3's prompts, then a ragged workload served with
    the decode graph and with the eager loop under a budget, then
    ``score`` against the impl='ref' engine."""
    from repro_torch.config import ControlConfig
    from repro_torch.serve import ServeEngine, synthetic_workload
    eng, stacks, cfg = mx["engine"], mx["stacks"], mx["cfg"]
    B, P, NEW = 4, 256, 32
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    eng.attach_offload(stacks, policy="ours", cache_capacity=3)
    gen = eng.generate(prompts, max_new=NEW)
    graphs = eng.num_graphs
    eng.attach_offload(stacks, policy="ours", cache_capacity=3)
    sv = eng.generate_many(list(prompts), max_new=NEW, num_slots=4, chunk=8)
    check_bytes("mixtral serve", sv)
    if eng.num_graphs != graphs:
        fail(f"serve on generate's bucket captured again: {graphs} -> "
             f"{eng.num_graphs} graphs")
    parted = serve_divergence(eng, prompts, gen, sv)
    if not parted:
        if gen.offload_report != sv.offload_report:
            fail(f"serve and generate: equal tokens and traces, offload "
                 f"reports differ: {sv.offload_report} vs "
                 f"{gen.offload_report}")
        log(f"  serve vs generate ({B} prompts x {P}, {NEW} new, 4 slots, "
            "chunk 8, policy 'ours', cache 3 of 8): tokens, traces and "
            "offload report identical")
    serve_line("mixtral serve", sv)

    def workload():
        return synthetic_workload(12, cfg.vocab_size, max_new=24, min_len=16,
                                  max_len=300, seed=5)

    budget = 0.75 * sv.offload_report["bytes_per_token"]
    runs = {}
    for name, graph in (("graph", True), ("eager", False)):
        e = eng if graph else ServeEngine(
            cfg, eng.params, quantized=True, kernel_impl="auto", device=dev,
            decode_graph=False)
        e.attach_offload(stacks, policy="ours", cache_capacity=3)
        e.attach_controller(ControlConfig(enabled=True,
                                          bytes_per_token=budget))
        before = e.num_graphs
        for c in counters.values():
            c.reset()
        st = e.serve(workload(), num_slots=4, chunk=8)
        runs[name] = (st, {n: c.n for n, c in counters.items()},
                      e.num_graphs - before)
        check_bytes(f"mixtral ragged {name}", st)
    (g, g_l, g_new), (e_st, e_l, _) = runs["graph"], runs["eager"]
    if not same_serve(g, e_st):
        fail("ragged serve: the decode graph and the eager loop differ")
    if g_new != 1:
        fail(f"ragged serve captured {g_new} graphs, expected 1")
    if len({p.tobytes() for p in g.plan_trace}) < 2:
        fail("ragged serve under a budget never changed the plan")
    log(f"  ragged serve (12 requests, prompts 16..300, 24 new, 4 slots, "
        f"chunk 8, budget {budget:.1f} B/token): graph and eager identical "
        f"(tokens, traces, offload report, plan trace of "
        f"{len({p.tobytes() for p in g.plan_trace})} distinct plans over "
        f"{g.chunks} chunks); 1 graph captured across the plan changes; "
        f"wrapper launches graph {g_l}, eager {e_l}")
    serve_line("mixtral ragged graph", g)
    serve_line("mixtral ragged eager", e_st)

    ref = ServeEngine(cfg, eng.params, quantized=True, kernel_impl="ref",
                      device=dev)
    s_k, s_r = eng.score(prompts), ref.score(prompts)
    rel = abs(s_k - s_r) / abs(s_r)
    if not rel <= SCORE_TOL:
        fail(f"score {s_k!r} against impl='ref' {s_r!r}: relative "
             f"{rel:.3e} (limit {SCORE_TOL})")
    log(f"  score ({B} x {P} tokens, mean NLL): {s_k!r} against impl='ref' "
        f"{s_r!r}, relative {rel:.3e} (limit {SCORE_TOL})")
    return {"launches": g_l, "eager_launches": e_l, "resident": sv,
            "prompts": prompts}


def serve_deepseek(dev, ds, counters) -> dict:
    """Phase 7's DeepSeek-MoE-16B (bf16): 16 ragged requests on 4 slots,
    twice (identical; the second under the profiler for the card's idle
    share), then the controller: the static plan, a plan pinned to
    top_n 0, a budget half-way between their tail bytes/token, twice."""
    from repro_torch.config import ControlConfig
    from repro_torch.serve import synthetic_workload
    eng, stacks, cfg = ds["engine"], ds["stacks"], ds["cfg"]

    def run(control=None):
        eng.attach_offload(stacks, policy="ours", cache_capacity=16)
        if control is not None:
            eng.attach_controller(control)
        torch.cuda.synchronize()
        return eng.serve(synthetic_workload(16, cfg.vocab_size, max_new=32,
                                            min_len=64, max_len=512,
                                            seed=7),
                         num_slots=4, chunk=8)

    g0 = eng.num_graphs
    for c in counters.values():
        c.reset()
    a1 = run()
    launches = {n: c.n for n, c in counters.items()}
    check_bytes("deepseek serve", a1)
    a2, busy_ms, _h2d, n_dev, wall = device_busy(run)
    busy_s = busy_ms / 1e3
    # the idle share's window is the profiled run's own serve window (no
    # capture in it: the first run captured)
    idle = 1 - busy_s / a2.total_s
    if not same_serve(a1, a2):
        fail("DeepSeek-MoE serve: two runs of one workload differ")
    g1 = eng.num_graphs
    serve_line("deepseek serve", a1)
    serve_line("deepseek serve profiled", a2, idle)
    log(f"  deepseek serve: two runs identical (tokens, traces, offload "
        f"report); card busy {busy_s:.3f} s of the profiled run's "
        f"{a2.total_s:.3f} s ({n_dev} device ops, {wall:.1f} s with the "
        f"profiler); graphs {g0} -> {g1}; wrapper launches {launches}")
    if g1 - g0 != 1:
        fail(f"DeepSeek serve captured {g1 - g0} graphs, expected 1")

    st = run(ControlConfig())
    hi = tail_bytes_per_token(eng.controller)
    if not same_serve(a1, st, plans=False):
        fail("an inactive controller changed DeepSeek-MoE serve")
    lo_st = run(ControlConfig(enabled=True, bytes_per_token=1.0,
                              max_top_n=0))
    lo = tail_bytes_per_token(eng.controller)
    if lo_st.plan_trace[:, :, 0].any():
        fail("the pinned top_n 0 plan compensated")
    g2 = eng.num_graphs
    budget = (lo + hi) / 2
    bud = ControlConfig(enabled=True, bytes_per_token=budget)
    b1 = run(bud)
    tail = tail_bytes_per_token(eng.controller)
    b2 = run(bud)
    if eng.num_graphs != g2 or g2 - g1 != 1:
        fail(f"the controlled runs captured {eng.num_graphs - g1} graphs, "
             "expected 1 across every plan")
    plans = len({p.tobytes() for p in b1.plan_trace})
    if plans < 2:
        fail("the budgeted run never changed the plan")
    if not lo <= tail <= hi:
        fail(f"budgeted tail {tail:.1f} B/token outside [lo {lo:.1f}, hi "
             f"{hi:.1f}]")
    if not abs(tail - budget) < abs(hi - budget):
        fail(f"budgeted tail {tail:.1f} B/token no closer to the budget "
             f"{budget:.1f} than the static plan's {hi:.1f}")
    if not np.array_equal(b1.plan_trace, b2.plan_trace) or \
            not same_serve(b1, b2):
        fail("a repeat of the budgeted run gave another plan trace")
    mean_n = b1.plan_trace[:, :, 0].mean(axis=1)
    mean_cap = b1.plan_trace[:, :, 1].mean(axis=1)
    log(f"  controller: tail bytes/token (last half of {b1.chunks} chunks) "
        f"static {hi:.1f}, top_n 0 {lo:.1f}, budget {budget:.1f} -> "
        f"{tail:.1f}; {plans} distinct plans; per-chunk mean top_n "
        f"{[round(float(x), 3) for x in mean_n]}, mean rank cap "
        f"{[round(float(x), 1) for x in mean_cap]}; final plan "
        f"{eng.controller.plan().summary()}; repeat identical; graphs "
        f"{g1} -> {eng.num_graphs} over 4 controlled runs")
    serve_line("deepseek static plan (inactive controller: the first "
               "run's work, the plan graph captured)", st)
    serve_line("deepseek top_n 0", lo_st)
    serve_line("deepseek budget", b1)
    return {"launches": launches, "eager_launches": {}, "resident": a1}


# ---------------------------------------------------------------------------
# phase 10: async expert streaming (run right after phase 8, on the
# weights and stacks of its engines)
# ---------------------------------------------------------------------------

def mem_available_gib() -> float:
    """The host's MemAvailable (``/proc/meminfo``), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def own_moe_params(params) -> dict:
    """``params`` with their own layer and MoE dicts (the same tensors and
    stacks): ``attach_streaming`` replaces an engine's MoE stacks with its
    containers, which must not reach the phase 8 engines' params."""
    return {**params, "layers": [dict(lp, moe=dict(lp["moe"]))
                                 if "moe" in lp else lp
                                 for lp in params["layers"]]}


def timed_backend(dev):
    """The engine's transfer backend with a pair of CUDA events around
    each H2D copy on its copy stream, and the payload bytes each moved:
    the link's physical rate, measured here (the engine counts wire
    bytes).  ``take()`` returns (payload bytes, seconds the copy stream
    spent copying, copies) since the last ``take``."""
    from repro_torch.offload.staging import DeviceTransferBackend

    class TimedBackend(DeviceTransferBackend):
        def __init__(self):
            super().__init__(dev)
            self.spans, self.nbytes = [], 0

        def copy(self, payload, tag=None, staging=None):
            if staging is not None and staging.free is not None:
                # the wait for the lane's buffer, outside the span
                self.stream.wait_event(staging.free)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(self.stream)
            h = super().copy(payload, tag, staging)
            b.record(self.stream)
            self.spans.append((a, b))
            self.nbytes += payload.nbytes
            return h

        def take(self):
            torch.cuda.synchronize(dev)
            secs = sum(a.elapsed_time(b) for a, b in self.spans) / 1e3
            out = (self.nbytes, secs, len(self.spans))
            self.spans, self.nbytes = [], 0
            return out

    return TimedBackend()


def check_oracle(name: str, eng, st) -> None:
    """Per store, metered wire bytes == the bytes its copies put on the
    link, and the run's report says the same."""
    for li, s in enumerate(eng._stores):
        if s.total_bytes != s.observed_copy_bytes:
            fail(f"{name}: store {li} metered {s.total_bytes} B, observed "
                 f"{s.observed_copy_bytes} B")
    rep = st.offload_report
    if rep["observed_copy_bytes"] != rep["total_bytes"]:
        fail(f"{name}: report metered {rep['total_bytes']} B, observed "
             f"{rep['observed_copy_bytes']} B")


def same_tokens_traces(a, b) -> bool:
    return (all(np.array_equal(x.tokens, y.tokens)
                and np.array_equal(x.trace, y.trace)
                for x, y in zip(a.results, b.results))
            and len(a.results) == len(b.results)
            and np.array_equal(a.router_trace, b.router_trace))


def stream_line(name: str, st, link, before=None) -> None:
    """Log one streamed run's wire bytes, physical bytes and link rate,
    and the stream engine's counters over the run (``before``: the
    engine's ``report()`` when the run started; None: a fresh engine)."""
    rep, sr = st.offload_report, dict(st.stream_report)
    for k, v in (before or {}).items():
        if k != "overlap_efficiency" and isinstance(v, (int, float)) \
                and not isinstance(v, bool) and k not in (
                    "ring_slots", "fallback_bits", "host_nbytes",
                    "in_flight"):
            sr[k] = sr[k] - v
    tok = max(rep["tokens"], 1)
    nbytes, secs, copies = link
    log(f"  {name}: wire {rep['total_bytes'] / tok / 1e6:.4f} MB/token "
        f"metered = {rep['observed_copy_bytes'] / tok / 1e6:.4f} observed "
        f"(demand {rep['demand_bytes'] / tok / 1e6:.4f}, compensator "
        f"{rep['compensator_bytes'] / tok / 1e6:.4f}, prefetch "
        f"{rep['prefetch_bytes'] / tok / 1e6:.4f} of which wasted "
        f"{rep['wasted_prefetch_bytes'] / tok / 1e6:.4f}); hit rate "
        f"{rep['hit_rate']:.4f}; {copies} copies moved {nbytes / 1e9:.3f} "
        f"GB of payload ({nbytes / tok / 1e6:.4f} MB/token) in "
        f"{secs:.3f} s of copy-stream time = link "
        f"{nbytes / max(secs, 1e-12) / 1e9:.2f} GB/s")
    log(f"  {name}: stream engine over the run: {sr['issued_copies']} "
        f"copies issued ({sr['issued_bytes'] / 1e9:.3f} GB wire), stalls "
        f"{sr['stalls']} ({sr['stall_s']:.3f} s), transfer_s "
        f"{sr['transfer_s']:.3f}, sync_copy_s {sr['sync_copy_s']:.3f}, "
        f"overlap_efficiency (cumulative) {sr['overlap_efficiency']:.4f}, "
        f"reruns {sr['reruns']}, degraded tokens {sr['degraded_tokens']}, "
        f"abandoned copies {sr['abandoned_copies']}, flushed "
        f"{sr['flushed_bytes']} B, in flight at the end {sr['in_flight']}; "
        f"meter {st.meter_s * 1e3 / max(st.chunks, 1):.2f} host ms/chunk")


def stream_mixtral(dev, mx, sv8, counters) -> dict:
    """Phase 3's Mixtral-8x7B (f32, 2 layers at full width), phase 8's
    "serve = generate" workload streamed under 'block' at cache 8 and at
    LRU 3 of 8: tokens and traces equal phase 8's resident serve, the
    oracle holds per store, no token degraded; a graph captured over the
    true stacks before ``attach_streaming`` is dropped; at cache 8 a warm
    second serve copies nothing."""
    from repro_torch.config import StreamConfig
    from repro_torch.serve import ServeEngine
    eng0, stacks, cfg = mx["engine"], mx["stacks"], mx["cfg"]
    want, prompts = sv8["resident"], sv8["prompts"]
    NEW = 32
    launches = None
    for cap in (8, 3):
        eng = ServeEngine(cfg, own_moe_params(eng0.params), quantized=True,
                          device=dev)
        eng.generate(prompts, max_new=NEW)        # the serve's bucket
        old = list(eng.graphs.values())
        eng.attach_offload(stacks, policy="ours", cache_capacity=cap)
        backend = timed_backend(dev)
        eng.attach_streaming(StreamConfig(enabled=True), backend=backend)
        if eng.num_graphs != 0:
            fail("attach_streaming kept a graph captured over the true "
                 "stacks")
        for c in counters.values():
            c.reset()
        st = eng.generate_many(list(prompts), max_new=NEW, num_slots=4,
                               chunk=8)
        link = backend.take()
        if cap == 8:
            launches = {n: c.n for n, c in counters.items()}
        name = f"mixtral stream cache {cap}"
        if not same_tokens_traces(st, want):
            fail(f"{name}: tokens or traces differ from phase 8's resident "
                 "serve")
        check_oracle(name, eng, st)
        check_bytes(name, st)
        if st.stream_report["degraded_tokens"]:
            fail(f"{name}: {st.stream_report['degraded_tokens']} tokens "
                 "degraded under 'block'")
        if eng.num_graphs != 1 or any(g is o for g in eng.graphs.values()
                                      for o in old):
            fail(f"{name}: {eng.num_graphs} graphs after the serve, or the "
                 "pre-streaming graph replayed")
        log(f"  {name} ({len(prompts)} prompts x {prompts.shape[1]}, {NEW} "
            f"new, 4 slots, chunk 8, block): tokens and traces equal phase "
            f"8's resident serve; metered == observed per store; "
            f"{eng.num_graphs} graph (the pre-streaming one dropped); host "
            f"image {eng.stream.report()['host_nbytes'] / 2**20:.1f} MiB "
            f"pinned in {eng.stream.image_s:.3f} s, fallback built in "
            f"{eng.stream.fallback_s:.3f} s")
        serve_line(name, st)
        stream_line(name, st, link)
        if cap == 8:
            sr = eng.stream.report()
            st2 = eng.generate_many(list(prompts), max_new=NEW, num_slots=4,
                                    chunk=8)
            link2 = backend.take()
            sr2 = st2.stream_report
            if (sr2["issued_copies"] != sr["issued_copies"]
                    or sr2["reruns"] != sr["reruns"] or link2[2]):
                fail(f"{name}: the warm serve issued "
                     f"{sr2['issued_copies'] - sr['issued_copies']} copies "
                     f"and re-ran {sr2['reruns'] - sr['reruns']} chunks")
            if not same_tokens_traces(st2, want):
                fail(f"{name}: the warm serve's tokens differ")
            check_oracle(name + " warm", eng, st2)
            log(f"  {name} warm second serve: no copy issued, no re-run, "
                f"same tokens; {st2.tokens_per_s:.2f} tok/s")
        del eng, backend
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": {}}


def copy_rate(dev, image) -> None:
    """Pinned H2D copies on a side stream between CUDA events: one
    DeepSeek-MoE expert weight payload (its three projections' codes and
    scales) and 1 GiB."""
    stream = torch.cuda.Stream(dev)
    small = image.weight_payload(0).data
    big = torch.empty((2**30,), dtype=torch.uint8, pin_memory=True)
    if not (small.is_pinned() and big.is_pinned()):
        fail("copy rate: a host source is not pinned")
    dst = torch.empty((2**30,), dtype=torch.uint8, device=dev)
    rates = []
    for name, src, iters in (("one expert payload", small, 200),
                             ("1 GiB", big, 5)):
        d = dst[:src.numel()]
        with torch.cuda.stream(stream):
            d.copy_(src, non_blocking=True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            for _ in range(iters):
                d.copy_(src, non_blocking=True)
            b.record(stream)
        b.synchronize()
        secs = a.elapsed_time(b) / 1e3
        rates.append(f"{name} ({src.numel() / 1e6:.3f} MB) "
                     f"{src.numel() * iters / secs / 1e9:.2f} GB/s "
                     f"({secs / iters * 1e3:.4f} ms each, {iters} copies)")
    log("  copy rate, pinned host -> device on a side stream: "
        + "; ".join(rates))
    del big, dst


def stream_deepseek(dev, ds, resident, counters) -> dict:
    """Phase 7's DeepSeek-MoE-16B (bf16, 28 layers), phase 8's workload
    (16 requests, prompts 64..512, 32 new, 4 slots, chunks of 8, LRU 16
    of 64, static plan) streamed: under 'block' twice (tokens and traces
    equal phase 8's resident run, the two runs identical, the oracle
    holds; the second run profiled for the card's idle share), then under
    'degrade' on fresh containers (it terminates; degraded tokens and
    tok/s).  Then the pinned copy rate."""
    from repro_torch.config import StreamConfig
    from repro_torch.serve import ServeEngine, synthetic_workload
    eng0, stacks, cfg = ds["engine"], ds["stacks"], ds["cfg"]

    def workload():
        return synthetic_workload(16, cfg.vocab_size, max_new=32,
                                  min_len=64, max_len=512, seed=7)

    def build(policy):
        mem0 = mem_available_gib()
        eng = ServeEngine(cfg, own_moe_params(eng0.params), quantized=True,
                          device=dev)
        eng.attach_offload(stacks, policy="ours", cache_capacity=16)
        backend = timed_backend(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eng.attach_streaming(StreamConfig(enabled=True, miss_policy=policy),
                             backend=backend)
        host = eng.stream.report()["host_nbytes"]
        pinned = sum(L.image.buffer.numel() for L in eng.stream.layers)
        log(f"  deepseek stream {policy}: host image "
            f"{host / 2**30:.3f} GiB of leaves in {pinned / 2**30:.3f} GiB "
            f"pinned ({len(eng.stream.layers)} layers), pinned and filled "
            f"in {eng.stream.image_s:.3f} s; fallback containers "
            f"({StreamConfig().fallback_bits}-bit RTN) built in "
            f"{eng.stream.fallback_s:.3f} s; host MemAvailable "
            f"{mem0:.1f} -> {mem_available_gib():.1f} GiB; device memory "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        return eng, backend

    eng, backend = build("block")
    g0 = eng.num_graphs
    for c in counters.values():
        c.reset()
    b1 = eng.serve(workload(), num_slots=4, chunk=8)
    link1 = backend.take()
    launches = {n: c.n for n, c in counters.items()}
    before2 = eng.stream.report()
    b2, busy_ms, h2d_ms, n_dev, wall = device_busy(
        lambda: eng.serve(workload(), num_slots=4, chunk=8))
    link2 = backend.take()
    idle = 1 - busy_ms / 1e3 / b2.total_s
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for name, st in (("deepseek stream block", b1),
                     ("deepseek stream block profiled", b2)):
        if not same_tokens_traces(st, resident):
            fail(f"{name}: tokens or traces differ from phase 8's resident "
                 "run")
        check_oracle(name, eng, st)
        check_bytes(name, st)
        if st.stream_report["degraded_tokens"]:
            fail(f"{name}: tokens degraded under 'block'")
    if eng.num_graphs - g0 != 1:
        fail(f"deepseek stream: {eng.num_graphs - g0} graphs captured over "
             "two serves, expected 1")
    serve_line("deepseek stream block", b1)
    stream_line("deepseek stream block", b1, link1)
    serve_line("deepseek stream block profiled", b2, idle)
    stream_line("deepseek stream block profiled", b2, link2, before2)
    log(f"  deepseek stream block: both runs' tokens and traces equal phase "
        f"8's resident run and each other; metered == observed per store; "
        f"card busy {busy_ms / 1e3:.3f} s (union of {n_dev} device ops, "
        f"H2D copies {h2d_ms / 1e3:.3f} s of them) of the profiled run's "
        f"{b2.total_s:.3f} s ({wall:.1f} s with the profiler): idle share "
        f"{idle:.3f}; peak device memory {peak:.2f} GiB; graphs "
        f"{eng.num_graphs}; wrapper launches {launches}")
    del eng, backend, b1, b2
    gc.collect()            # the stores and the stream engine point at each other
    torch.cuda.empty_cache()

    eng, backend = build("degrade")
    d1 = eng.serve(workload(), num_slots=4, chunk=8)
    linkd = backend.take()
    check_oracle("deepseek stream degrade", eng, d1)
    check_bytes("deepseek stream degrade", d1)
    serve_line("deepseek stream degrade", d1)
    stream_line("deepseek stream degrade", d1, linkd)
    log(f"  deepseek stream degrade: terminated, "
        f"{d1.stream_report['degraded_tokens']} of {d1.generated_tokens} "
        f"tokens degraded; {d1.tokens_per_s:.2f} tok/s")
    copy_rate(dev, eng.stream.layers[0].image)
    del eng, backend
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": {},
            "link_gbs": link1[0] / max(link1[1], 1e-12) / 1e9}


# ---------------------------------------------------------------------------
# phase 11: the paged KV cache (run after phase 10 on phase 8's engines,
# before phase 9)
# ---------------------------------------------------------------------------

def paged_divergence(name: str, a, b, tol: float, relative: bool) -> dict:
    """Requests of two serve runs of one workload whose tokens or traces
    differ: each must first differ at a step where the two runs' chosen
    tokens were near-tied, i.e. where each run's probability of its own
    (greedy) token agrees with the other's within ``tol`` (``relative``:
    ``tol`` times the larger).  At a genuine near-tie the two runs' top
    probabilities agree to rounding; a real fault moves them apart.
    Returns {uid: first differing step}."""
    first = {}
    for x, y in zip(a.results, b.results):
        n = min(len(x.tokens), len(y.tokens))
        bad = np.nonzero((x.tokens[:n] != y.tokens[:n])
                         | (x.trace[:n] != y.trace[:n]).any(axis=(1, 2)))[0]
        if len(x.tokens) != len(y.tokens) and not bad.size:
            bad = np.array([n])
        if not bad.size:
            continue
        t = int(bad[0])
        pa = math.exp(float(x.logprobs[min(t, len(x.tokens) - 1)]))
        pb = math.exp(float(y.logprobs[min(t, len(y.tokens) - 1)]))
        lim = tol * max(pa, pb) if relative else tol
        if abs(pa - pb) > lim:
            fail(f"{name}: request {x.uid} first differs at step {t} with "
                 f"p {pa:.6f} against {pb:.6f}: no near-tie (limit "
                 f"{lim:.2e})")
        first[x.uid] = t
    return first


def cache_line(name: str, st, base=None) -> None:
    pr = st.page_report
    log(f"  {name}: cache {st.cache_hbm_bytes / 1e6:.2f} MB "
        f"({st.cache_hbm_bytes_per_token / 1e6:.4f} MB/token)"
        + ("" if base is None else
           f", {st.cache_hbm_bytes / base.cache_hbm_bytes:.4f} of the "
           f"contiguous run's {base.cache_hbm_bytes / 1e6:.2f} MB")
        + f"; {st.prefill_tokens} prefill tokens"
        + ("" if pr is None else
           f"; pages ({pr['num_pages']}x{pr['page_size']}): {pr['allocs']} "
           f"allocs, prefix hit {pr['prefix_hit_rate']:.4f} "
           f"({pr['prefix_hits']}/{pr['prefix_queries']}), peak shared ref "
           f"{pr['peak_shared_ref']}, peak live {pr['peak_live']}, "
           f"{pr['evictions']} evictions"))


def same_bytes(a, b) -> bool:
    return (a.offload_report == b.offload_report
            and [r.offload_bytes for r in a.results]
            == [r.offload_bytes for r in b.results])


def paged_mixtral(dev, mx, counters) -> dict:
    """Phase 3's Mixtral-8x7B (f32, 2 layers): phase 8's ragged workload
    served contiguous and paged (page 16) at LRU 3 of 8: tokens, traces
    and metered bytes equal (a first divergence only at an f32 near-tie),
    one capture for the paged envelope, a second ragged workload in the
    same envelope capturing none, no page leak, a smaller cache; then
    the paged serve under streaming 'block' at LRU 3 equal to the
    resident paged serve."""
    import dataclasses
    from repro_torch.config import StreamConfig
    from repro_torch.serve import ServeEngine, synthetic_workload
    eng, stacks, cfg = mx["engine"], mx["stacks"], mx["cfg"]

    def workload():
        return synthetic_workload(12, cfg.vocab_size, max_new=24, min_len=16,
                                  max_len=300, seed=5)

    def run(e, reqs, **kw):
        e.attach_offload(stacks, policy="ours", cache_capacity=3)
        e._controller = None
        return e.serve(reqs, num_slots=4, chunk=8, **kw)

    run(eng, workload())        # captures the contiguous no-plan graph
    base = run(eng, workload())
    g0 = eng.num_graphs
    for c in counters.values():
        c.reset()
    paged = run(eng, workload(), page_size=16)
    launches = {n: c.n for n, c in counters.items()}
    g1 = eng.num_graphs
    warm = run(eng, workload(), page_size=16)
    if not same_serve(paged, warm, plans=False):
        fail("mixtral paged: two paged runs of one workload differ")
    parted = paged_divergence("mixtral paged", base, paged, NEAR_TIE, False)
    if not parted and not same_bytes(base, paged):
        fail("mixtral paged: equal tokens and traces, metered bytes differ")
    if g1 - g0 != 1:
        fail(f"mixtral paged captured {g1 - g0} graphs, expected 1")
    if not paged.cache_hbm_bytes < base.cache_hbm_bytes:
        fail(f"mixtral paged cache {paged.cache_hbm_bytes} B not below the "
             f"contiguous {base.cache_hbm_bytes} B")
    eng._page_pool.check_leaks()
    rng = np.random.default_rng(6)
    other = [dataclasses.replace(r, tokens=rng.integers(
        2, cfg.vocab_size, (r.prompt_len,)).astype(np.int32))
        for r in workload()]
    second = run(eng, other, page_size=16)
    eng._page_pool.check_leaks()
    if eng.num_graphs != g1:
        fail("mixtral paged: a second workload in the same envelope "
             "captured again")
    if second.cache_hbm_bytes != paged.cache_hbm_bytes:
        fail("mixtral paged: the second workload's envelope differs")
    log(f"  mixtral paged (12 requests, prompts 16..300, 24 new, 4 slots, "
        f"chunk 8, page 16, LRU 3 of 8): "
        + ("tokens, traces and metered bytes equal the contiguous run's"
           if not parted else f"requests part at near-ties: {parted}")
        + f"; graphs {g0} -> {g1} (key "
        f"{[k for k in eng.graphs if len(k) == 5]}), a second ragged "
        f"workload in the envelope captured none; no page leaked; wrapper "
        f"launches {launches}")
    serve_line("mixtral contiguous (warm)", base)
    serve_line("mixtral paged (capturing)", paged)
    serve_line("mixtral paged (warm)", warm)
    cache_line("mixtral contiguous", base)
    cache_line("mixtral paged", paged, base)

    se = ServeEngine(cfg, own_moe_params(eng.params), quantized=True,
                     device=dev)
    se.attach_offload(stacks, policy="ours", cache_capacity=3)
    backend = timed_backend(dev)
    se.attach_streaming(StreamConfig(enabled=True), backend=backend)
    st = se.serve(workload(), num_slots=4, chunk=8, page_size=16)
    link = backend.take()
    if not same_tokens_traces(st, paged):
        fail("mixtral paged stream: tokens or traces differ from the "
             "resident paged serve")
    check_oracle("mixtral paged stream", se, st)
    check_bytes("mixtral paged stream", st)
    if st.stream_report["degraded_tokens"]:
        fail("mixtral paged stream: tokens degraded under 'block'")
    se._page_pool.check_leaks()
    log("  mixtral paged stream (block, LRU 3): tokens and traces equal the "
        "resident paged serve; metered == observed per store; no page "
        "leaked")
    serve_line("mixtral paged stream", st)
    stream_line("mixtral paged stream", st, link)
    del se, backend
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": {}}


def shared_prompt_workload(cfg, rng):
    """16 requests: one 256-token system prompt shared by all, then 32..256
    tokens of each request's own, 32 new tokens."""
    from repro_torch.serve import Request
    sysp = rng.integers(2, cfg.vocab_size, (256,))
    return [Request(uid=i, tokens=np.concatenate([
        sysp, rng.integers(2, cfg.vocab_size, (int(rng.integers(32, 257)),))
    ]).astype(np.int32), max_new=32) for i in range(16)]


def projection(eng, cfg, st, measured_tok_s: float, link_gbs: float) -> None:
    """``simulate_decode`` (the paper's analytic two-resource pipeline,
    batch-1 request streams) on DeepSeek-MoE's served trace (every
    request's decode routing, concatenated) under the paper's GPU-only
    and GPU-NDP profiles, and GPU-only at this card's measured per-copy
    link rate, beside the measured serve."""
    import dataclasses
    from repro_torch.offload import (GPU_NDP, GPU_ONLY, LayerSpecSim,
                                     simulate_decode)
    trace = np.concatenate([r.trace for r in st.results])
    stores = eng._stores
    E = cfg.moe.num_experts
    spec = LayerSpecSim(
        d_model=cfg.d_model, d_expert=cfg.moe.d_expert, num_experts=E,
        top_k=cfg.moe.top_k, bytes_fp16=stores[0].expert_bytes(0, "fp16"),
        bytes_quant=stores[0].expert_bytes(0, "quant"),
        comp_bytes=[int(np.mean([s.compensator_bytes(e) for s in stores]))
                    for e in range(E)])
    measured = dataclasses.replace(GPU_ONLY, name="gpu-only-measured-link",
                                   link_bw=link_gbs * 1e9)
    parts = []
    for prof, pols in ((GPU_ONLY, ("fp16", "quant", "ours")),
                       (GPU_NDP, ("fp16", "quant", "ours", "ours_ndp")),
                       (measured, ("fp16", "quant", "ours"))):
        for pol in pols:
            r = simulate_decode(trace, spec, prof, pol,
                                top_n=cfg.moe.quant.top_n_restore,
                                cache_capacity=16, num_layers=trace.shape[1])
            parts.append(f"{prof.name} {pol} {r.tokens_per_s:.2f} tok/s "
                         f"({r.transfer_bytes_per_token / 1e6:.2f} MB/token, "
                         f"link {r.transfer_time_frac:.3f})")
    log(f"  projection (simulate_decode on DeepSeek's served trace, "
        f"{trace.shape[0]} tokens x {trace.shape[1]} layers, LRU 16, batch-1 "
        f"streams; measured link {link_gbs:.2f} GB/s per copy): "
        + "; ".join(parts) + f"; measured paged serve {measured_tok_s:.2f} "
        f"tok/s over its window (4 slots, experts resident)")


def paged_deepseek(dev, ds, resident, counters, link_gbs: float) -> dict:
    """Phase 7's DeepSeek-MoE-16B (bf16, 28 layers): phase 8's 16 requests
    paged (page 16, LRU 16 of 64) against phase 8's contiguous run
    (tokens equal up to a first divergence at a bf16 near-tie, metered
    bytes equal where the tokens are; one capture; a smaller cache); the
    shared-system-prompt workload with prefix reuse off and on (fewer
    prefill tokens, a page shared by two or more); the projection."""
    from repro_torch.serve import synthetic_workload
    eng, stacks, cfg = ds["engine"], ds["stacks"], ds["cfg"]

    def run(reqs, **kw):
        eng.attach_offload(stacks, policy="ours", cache_capacity=16)
        eng._controller = None
        torch.cuda.synchronize()
        return eng.serve(reqs, num_slots=4, chunk=8, page_size=16, **kw)

    g0 = eng.num_graphs
    for c in counters.values():
        c.reset()
    paged = run(synthetic_workload(16, cfg.vocab_size, max_new=32,
                                   min_len=64, max_len=512, seed=7))
    launches = {n: c.n for n, c in counters.items()}
    if eng.num_graphs - g0 != 1:
        fail(f"deepseek paged captured {eng.num_graphs - g0} graphs, "
             "expected 1")
    parted = paged_divergence("deepseek paged", resident, paged,
                              NEAR_TIE_BF16, True)
    if not parted and not same_bytes(resident, paged):
        fail("deepseek paged: equal tokens and traces, metered bytes differ")
    if not paged.cache_hbm_bytes < resident.cache_hbm_bytes:
        fail("deepseek paged cache not below the contiguous run's")
    check_bytes("deepseek paged", paged)
    log(f"  deepseek paged (phase 8's 16 requests, page 16, LRU 16 of 64): "
        + ("tokens, traces and metered bytes equal phase 8's contiguous run"
           if not parted else
           f"requests part from phase 8's contiguous run at bf16 near-ties "
           f"(first steps {parted}); the rest equal")
        + f"; wrapper launches {launches}")
    serve_line("deepseek contiguous (phase 8)", resident)
    serve_line("deepseek paged", paged)
    cache_line("deepseek contiguous (phase 8)", resident)
    cache_line("deepseek paged", paged, resident)

    runs = {}
    for prefix in (False, True):
        runs[prefix] = run(shared_prompt_workload(
            cfg, np.random.default_rng(11)), prefix_cache=prefix)
        check_bytes(f"deepseek shared prompt prefix={prefix}", runs[prefix])
    off, on = runs[False], runs[True]
    rep = on.page_report
    if not on.prefill_tokens < off.prefill_tokens:
        fail(f"prefix reuse prefilled {on.prefill_tokens} tokens, not below "
             f"{off.prefill_tokens}")
    if rep["peak_shared_ref"] < 2:
        fail(f"prefix reuse: peak shared ref {rep['peak_shared_ref']}")
    same = sum(np.array_equal(x.tokens, y.tokens)
               for x, y in zip(off.results, on.results))
    for name, st in (("off", off), ("on", on)):
        tt = st.ttft_percentiles()
        log(f"  deepseek shared prompt (16 requests: 256 shared + 32..256 "
            f"own tokens, 32 new, page 16), prefix reuse {name}: "
            f"{st.prefill_tokens} prefill tokens, prefix hit rate "
            f"{st.page_report['prefix_hit_rate']:.4f}, peak shared ref "
            f"{st.page_report['peak_shared_ref']}, TTFT p50/p95 "
            f"{tt[50.0] * 1e3:.1f}/{tt[95.0] * 1e3:.1f} ms, "
            f"{st.tokens_per_s:.2f} tok/s")
        serve_line(f"deepseek shared prompt prefix {name}", st)
        cache_line(f"deepseek shared prompt prefix {name}", st)
    log(f"  deepseek shared prompt: prefill tokens {off.prefill_tokens} -> "
        f"{on.prefill_tokens} ({on.prefill_tokens / off.prefill_tokens:.4f})"
        f"; {same} of 16 requests' tokens identical with reuse on and off "
        f"(bf16: the suffix prefill attends over the stored prefix, the "
        f"full prefill over recomputed rows)")
    admission_profile(eng, cfg)
    projection(eng, cfg, paged, paged.tokens_per_s, link_gbs)
    return {"launches": launches, "eager_launches": {}}


def admission_profile(eng, cfg) -> None:
    """Where a batch-1 admission's time goes, full prompt against suffix:
    one shared-prompt request's full prefill (padded to 512) and the
    suffix prefill of its tokens past the 256 shared ones over the same
    cache, each timed on the host clock (mean of 3, synchronised) and
    once under the profiler (device busy, kernels, the top 8)."""
    req = shared_prompt_workload(cfg, np.random.default_rng(12))[0]
    plen = req.prompt_len
    toks = eng._pad_prompt(np.asarray(req.tokens, np.int32)[None])
    suf = np.zeros((1, -(-(plen - 256) // 16) * 16), np.int32)
    suf[0, :plen - 256] = req.tokens[256:]
    _, rc = eng._prefill_into(toks, plen, toks.shape[1])
    calls = {"full": lambda: eng._prefill_into(toks, plen, toks.shape[1]),
             "suffix": lambda: eng._prefill_suffix(rc, suf, 256, plen)}
    for name in ("suffix", "full"):
        fn = calls[name]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 3
        kernels, wall = profiled(fn)
        busy = sum(ms for _, ms in kernels)
        n_tok = toks.shape[1] if name == "full" else suf.shape[1]
        log(f"  admission profile, {name} prefill ({n_tok} tokens, batch "
            f"1): host {host * 1e3:.3f} ms unprofiled, device busy "
            f"{busy:.3f} ms ({busy / (host * 1e3):.3f} of it), "
            f"{len(kernels)} kernels, {wall * 1e3:.3f} ms profiled")
        log_top(kernels, 1, "admission")


# ---------------------------------------------------------------------------
# phase 12: speculative decoding (run after phase 11 on phase 8's engines)
# ---------------------------------------------------------------------------

class NeverRight:
    """A drafter that always proposes one token: with a token that no
    greedy stream of the workload emits, every draft is rejected."""

    def __init__(self, token: int):
        self.token = token

    def reset_slot(self, slot, toks):
        pass

    def observe(self, slot, toks):
        pass

    def propose_all(self, num_slots, k):
        return np.full((num_slots, k), self.token, np.int32)


def spec_line(name: str, st, base=None, idle=None) -> None:
    """Log one speculative serve's numbers (``base``: the plain serve of
    the same workload, for wire bytes and decode tok/s)."""
    sp, rep = st.spec_report, st.offload_report
    tok = max(rep["tokens"], 1)
    slot_rounds = sp["drafted_tokens"] / sp["spec_k"]
    la = sp["lookahead_accuracy"]
    log(f"  {name}: acceptance {sp['acceptance_rate']:.4f} "
        f"({sp['accepted_draft_tokens']}/{sp['drafted_tokens']} drafts over "
        f"{sp['rounds']} rounds), mean accepted length "
        f"{1 + sp['accepted_draft_tokens'] / max(slot_rounds, 1):.4f} "
        f"tokens per slot-round; lookahead accuracy "
        f"{'n/a' if la is None else format(la, '.4f')}, lookahead "
        f"{sp['lookahead_prefetch_bytes'] / 1e6:.2f} MB, draft overhead "
        f"{sp['draft_overhead_bytes'] / 1e6:.2f} MB "
        f"({sp['draft_overhead_bytes'] / tok / 1e6:.4f} MB/token); wire "
        f"{rep['bytes_per_token'] / 1e6:.4f} MB/token"
        + ("" if base is None else
           f" (plain serve "
           f"{base.offload_report['bytes_per_token'] / 1e6:.4f})")
        + f"; decode {st.generated_tokens / st.decode_s:.2f} tok/s over "
        f"rounds"
        + ("" if base is None else
           f" (plain serve {base.generated_tokens / base.decode_s:.2f} in "
           f"chunks)")
        + f"; TTFT p50 {st.ttft_percentiles()[50.0] * 1e3:.1f} ms; drafter "
        f"{st.draft_s * 1e3 / st.chunks:.3f} host ms/round, verify round "
        f"{(st.decode_s - st.draft_s) * 1e3 / st.chunks:.3f} ms/round; "
        f"capture {st.capture_s:.3f} s"
        + ("" if idle is None else f"; card idle share {idle:.3f}"))


def token_divergence(name: str, a, b, tol: float) -> tuple:
    """Requests of two serve runs of one workload whose tokens differ:
    each must first differ at a near-tie of ``a``'s distribution (each
    run's probability of its own greedy token within ``tol`` times the
    larger, as ``paged_divergence`` reads them).  Returns ({uid: first
    differing token step}, the number of requests whose router traces
    differ before any token does: bf16 router near-ties)."""
    first, flips = {}, 0
    for x, y in zip(a.results, b.results):
        n = min(len(x.tokens), len(y.tokens))
        bad = np.nonzero(x.tokens[:n] != y.tokens[:n])[0]
        t = int(bad[0]) if bad.size else n
        flips += bool((x.trace[:t] != y.trace[:t]).any())
        if not bad.size and len(x.tokens) == len(y.tokens):
            continue
        pa = math.exp(float(x.logprobs[min(t, len(x.tokens) - 1)]))
        pb = math.exp(float(y.logprobs[min(t, len(y.tokens) - 1)]))
        if abs(pa - pb) > tol * max(pa, pb):
            fail(f"{name}: request {x.uid} first differs at token {t} with "
                 f"p {pa:.6f} against {pb:.6f}: no near-tie")
        first[x.uid] = t
    return first, flips


def unseen_token(vocab: int, *streams) -> int:
    """The first token id that none of ``streams`` (token arrays) holds."""
    seen = set(int(t) for a in streams for t in np.asarray(a).reshape(-1))
    return next(t for t in range(2, vocab) if t not in seen)


def spec_mixtral(dev, mx, sv8, counters) -> dict:
    """Phase 3's Mixtral-8x7B (f32, 2 layers), phase 8's "serve =
    generate" workload (4 prompts x 256, 32 new, 4 slots, LRU 3 of 8) in
    speculative rounds: n-gram drafts at k 3 (the counted run) and 1, the
    'model' and 'self' (window 64) drafters, a drafter that is always
    wrong (acceptance exactly 0), paged at page 16, and streamed 'block'
    at LRU 3; each equal to phase 8's plain serve but for first
    divergences at f32 near-ties, one verify capture per key, metered ==
    observed under streaming."""
    from repro_torch.config import StreamConfig
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.speculative import DraftModelDrafter
    eng, stacks, cfg = mx["engine"], mx["stacks"], mx["cfg"]
    want, prompts = sv8["resident"], sv8["prompts"]
    NEW = 32

    def reqs():
        return [Request(uid=i, tokens=p, max_new=NEW, eos_id=None)
                for i, p in enumerate(prompts)]

    def run(e=eng, **kw):
        e.attach_offload(stacks, policy="ours", cache_capacity=3)
        e._controller = None
        return e.serve(reqs(), num_slots=4, chunk=8, **kw)

    g0 = eng.num_spec_graphs
    for c in counters.values():
        c.reset()
    fd.multi_launches.reset()
    runs = {"ngram k3": run(spec_k=3)}
    launches = {n: c.n for n, c in counters.items()}
    multi = fd.multi_launches.n
    runs["ngram k1"] = run(spec_k=1)
    runs["model k3"] = run(spec_k=3, drafter="model")
    runs["self k3 (window 64)"] = run(spec_k=3, drafter=DraftModelDrafter
                                      .self_draft(cfg, eng.params, window=64,
                                                  quantized=True))
    longer = eng.generate(prompts, max_new=NEW + 8)
    tok = unseen_token(cfg.vocab_size, longer.tokens,
                       *[r.tokens for r in want.results])
    runs["always wrong k3"] = run(spec_k=3, drafter=NeverRight(tok))
    runs["ngram k3 paged 16"] = run(spec_k=3, page_size=16)
    captures = eng.num_spec_graphs - g0
    parted = {}
    for name, st in runs.items():
        check_bytes(f"mixtral spec {name}", st)
        parted[name] = paged_divergence(f"mixtral spec {name}", want, st,
                                        NEAR_TIE, False)
    if runs["always wrong k3"].spec_report["acceptance_rate"] != 0.0:
        fail(f"mixtral spec: the always-wrong drafter (token {tok}) "
             f"accepted {runs['always wrong k3'].spec_report}")
    if captures != 3:
        fail(f"mixtral spec captured {captures} verify graphs, expected 3 "
             "(k 3 and k 1 contiguous, k 3 paged)")
    if multi <= 0:
        fail("mixtral spec: the verify pass never ran flash-decode's "
             "multi-query mode")
    eng._page_pool.check_leaks()

    se = ServeEngine(cfg, own_moe_params(eng.params), quantized=True,
                     device=dev)
    se.attach_offload(stacks, policy="ours", cache_capacity=3)
    backend = timed_backend(dev)
    se.attach_streaming(StreamConfig(enabled=True), backend=backend)
    st = se.serve(reqs(), num_slots=4, chunk=8, spec_k=3)
    link = backend.take()
    if not same_tokens_traces(st, runs["ngram k3"]):
        fail("mixtral spec stream: tokens or traces differ from the "
             "resident speculative serve")
    check_oracle("mixtral spec stream", se, st)
    check_bytes("mixtral spec stream", st)
    if st.stream_report["degraded_tokens"]:
        fail("mixtral spec stream: tokens degraded under 'block'")
    log(f"  mixtral spec ({len(prompts)} prompts x {prompts.shape[1]}, "
        f"{NEW} new, 4 slots, LRU 3 of 8): against phase 8's plain serve, "
        + "; ".join(f"{n}: " + ("equal" if not parted[n] else
                                f"requests part at near-ties {parted[n]}")
                    for n in runs)
        + f"; {sum(len(v) for v in parted.values())} near-tie divergences "
        f"in all; {captures} verify captures (keys "
        f"{sorted(k[:3] for k in eng.spec_graphs)}); the always-wrong "
        f"drafter (token {tok}) accepted 0; wrapper launches of the k 3 run "
        f"{launches}, {multi} of flash-decode's in its multi-query mode; "
        f"streamed 'block' equals the resident k 3 run, metered == observed")
    for name, r in runs.items():
        spec_line(f"mixtral spec {name}", r, want)
    spec_line("mixtral spec stream block k3", st, want)
    stream_line("mixtral spec stream block k3", st, link)
    del se, backend
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": {}, "multi": multi}


def spec_deepseek(dev, ds, resident, counters) -> dict:
    """Phase 7's DeepSeek-MoE-16B (bf16, 28 layers), phase 8's 16 requests
    (prompts 64..512, 4 slots, LRU 16 of 64) with n-gram drafts at k 3,
    twice (the first captures the verify graph, the second is profiled
    for the card's idle share; the two identical): tokens equal phase 8's
    plain run but for first divergences at bf16 near-ties, whose count is
    printed; then 4 of the requests at temperature 0.8."""
    import dataclasses
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.serve import synthetic_workload
    eng, stacks, cfg = ds["engine"], ds["stacks"], ds["cfg"]

    def workload():
        return synthetic_workload(16, cfg.vocab_size, max_new=32,
                                  min_len=64, max_len=512, seed=7)

    def run(reqs=None):
        eng.attach_offload(stacks, policy="ours", cache_capacity=16)
        eng._controller = None
        torch.cuda.synchronize()
        return eng.serve(workload() if reqs is None else reqs, num_slots=4,
                         chunk=8, spec_k=3)

    g0 = eng.num_spec_graphs
    for c in counters.values():
        c.reset()
    fd.multi_launches.reset()
    a1 = run()
    launches = {n: c.n for n, c in counters.items()}
    multi = fd.multi_launches.n
    a2, busy_ms, _h2d, n_dev, wall = device_busy(run)
    idle = 1 - busy_ms / 1e3 / a2.total_s
    if not same_serve(a1, a2, plans=False):
        fail("deepseek spec: two runs of one workload differ")
    if eng.num_spec_graphs - g0 != 1:
        fail(f"deepseek spec captured {eng.num_spec_graphs - g0} verify "
             "graphs, expected 1")
    if multi <= 0:
        fail("deepseek spec: the verify pass never ran flash-decode's "
             "multi-query mode")
    check_bytes("deepseek spec", a1)
    parted, flips = token_divergence("deepseek spec", resident, a1,
                                     NEAR_TIE_BF16)
    log(f"  deepseek spec (phase 8's 16 requests, k 3, n-gram, LRU 16 of "
        f"64): two runs identical; "
        + ("tokens equal phase 8's plain run" if not parted else
           f"{len(parted)} requests' tokens part from phase 8's plain run "
           f"at bf16 near-ties (first token steps {parted}); the rest "
           f"equal")
        + f"; {len(parted)} near-tie token divergences; router traces "
        f"differ before any token in {flips} of 16 requests (bf16 router "
        f"near-ties: the verify pass's projections run at M 16, the plain "
        f"step's at M 4); 1 verify capture; card "
        f"busy {busy_ms / 1e3:.3f} s of the profiled run's "
        f"{a2.total_s:.3f} s ({n_dev} device ops, {wall:.1f} s with the "
        f"profiler); wrapper launches {launches}, {multi} of flash-decode's "
        f"in its multi-query mode")
    spec_line("deepseek spec k3", a1, resident)
    spec_line("deepseek spec k3 profiled", a2, resident, idle)
    serve_line("deepseek spec k3", a1)

    old = eng.scfg
    try:
        eng.scfg = dataclasses.replace(old, temperature=0.8)
        hot = run(workload()[:4])
    finally:
        eng.scfg = old
    for r in hot.results:
        if not np.all(np.isfinite(r.logprobs)) or not (
                r.gen_tokens == 32 or r.finish_reason == "eos"):
            fail(f"deepseek spec temperature 0.8: request {r.uid} gave "
                 f"{r.gen_tokens} tokens ({r.finish_reason}), finite "
                 f"log-probs {bool(np.all(np.isfinite(r.logprobs)))}")
    log(f"  deepseek spec temperature 0.8 (4 of the requests, k 3): "
        f"{[r.gen_tokens for r in hot.results]} tokens, log-probs finite")
    spec_line("deepseek spec k3 temperature 0.8", hot)
    return {"launches": launches, "eager_launches": {}, "multi": multi,
            "idle": idle}


# ---------------------------------------------------------------------------
# phase 13: sliding-window models (Gemma3-1B, Gemma3-27B) and QKV biases
# (Qwen2-7B), run after phase 12 (before phase 9)
# ---------------------------------------------------------------------------

# the depth cuts: Gemma3-27B's 62 layers are ~54 GB of bf16 weights, and
# two 5 + 1 periods keep every position of the pattern (10 local and 2
# global layers); Qwen2-7B's 28 layers go to 4 (QKV biases are the new
# path; its widths stay as published)
GEMMA3_27B_LAYERS = 12
QWEN2_LAYERS = 4
# cell -> (arch, depth (None: as published), dtype, prompt length)
WINDOW_CELLS = {"gemma3_1b": ("gemma3-1b", None, torch.float32, 640),
                "gemma3_27b": ("gemma3-27b", GEMMA3_27B_LAYERS,
                               torch.bfloat16, 1280),
                "qwen2_7b": ("qwen2-7b", QWEN2_LAYERS, torch.bfloat16, 256)}


def window_config(arch: str, layers):
    import dataclasses
    from repro_torch.models.transformer import layer_specs
    from repro_torch.registry import get_config
    full = get_config(arch)
    cut = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    kinds = [s.mixer for s in layer_specs(cut)]
    log(f"  config {cut.name}: d_model {cut.d_model}, heads {cut.num_heads}"
        f"/{cut.num_kv_heads} kv (G {cut.q_per_kv}), head_dim "
        f"{cut.head_dim}, d_ff {cut.d_ff}, vocab {cut.vocab_size}, tied "
        f"embeddings {cut.tie_embeddings}, act {cut.act}, rope theta "
        f"{cut.rope_theta} (local {cut.rope_local_theta}), qkv bias "
        f"{cut.qkv_bias}, post norms {cut.post_attn_norm}, scaled "
        f"embeddings {cut.scale_embed}; {kinds.count('local')} local layers "
        f"(window {cut.window_size}), {kinds.count('global')} global")
    log("  depth " + (f"{full.num_layers} layers, as published (no cut)"
                      if layers is None else
                      f"cut: {full.num_layers} -> {layers} layers (widths "
                      f"as published)"))
    return cut


def window_cell(dev, name: str) -> dict:
    """One cell of phase 13: random weights from a seed (Qwen2-7B's QKV
    biases seeded nonzero: the JAX package initialises them to zeros),
    dense FFNs compressed to E = 1 stacks, then ``serve_slice`` (graph
    against eager, the profiles) on 4 prompts and ``teacher_forced``
    against the impl='ref' engine.  The eager loop must launch
    flash-decode once per layer and step, with a window on every local
    layer, and kernel 3 three times per layer and forward."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params, layer_specs)
    from repro_torch.serve.engine import ServeEngine
    arch, layers, dtype, P = WINDOW_CELLS[name]
    cfg = window_config(arch, layers)
    B, NEW = 4, 32
    n_local = sum(s.mixer == "local" for s in layer_specs(cfg))
    log(f"  weights, activations and KV cache in {dtype}; {B} prompts x {P}"
        f" tokens, {NEW} new")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    if cfg.qkv_bias:
        gen = torch.Generator(device=dev).manual_seed(29)
        for lp in params["layers"]:
            for b in ("bq", "bk", "bv"):
                t = lp["attn"][b]
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
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
    prompts = np.random.default_rng(13).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    sv = serve_slice(dev, cfg_q, qparams, prompts, NEW, {
        "quant_matmul": qm.qmm_launches,
        "flash_decode_attention": fd.launches,
        "fused_expert_matmul": qm.launches,
        "flash_decode_window": fd.window_launches})
    eng, res = sv["engine"], sv["graph"]
    launches, eager = sv["launches"], sv["eager_launches"]
    window = {"graph": launches.pop("flash_decode_window"),
              "eager": eager.pop("flash_decode_window")}
    L = cfg.num_layers
    want = {"flash_decode_attention": L * NEW, "quant_matmul": 3 * L * (NEW + 1),
            "fused_expert_matmul": 0}
    if eager != want or window["eager"] != n_local * NEW:
        fail(f"{name}: the eager loop's launches {eager}, with a window "
             f"{window['eager']}; expected {want}, with a window "
             f"{n_local * NEW} (one per local layer and step)")
    if min(launches["quant_matmul"], launches["flash_decode_attention"]) <= 0 \
            or (n_local and window["graph"] <= 0):
        fail(f"{name}: a kernel of the path was never launched: {launches},"
             f" with a window {window['graph']}")
    log(f"  {name}: eager loop launches flash-decode {L} times a step, "
        f"{n_local} of them with a window (one per local layer), and "
        f"kernel 3 {3 * L} times a forward (every FFN projection)")
    check_generation(res, B, NEW, cfg.vocab_size)
    if res.router_trace is not None:
        fail("a dense model returned a router trace")
    ref = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="ref",
                      device=dev)
    teacher_forced(eng, ref, prompts, res.tokens, 0, dtype)
    del ref
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": eager, "window": window,
            "engine": eng, "stacks": stacks, "cfg": cfg_q,
            "profile": sv["profile"], "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW}


def logit_near_tie(eng, prompt, toks, other, step: int) -> float:
    """The gap between ``toks[step]``'s and ``other[step]``'s logits as a
    share of the largest |logit|, one request (``prompt``) teacher-forced
    on ``toks`` up to ``step``."""
    logits, caches = eng.prefill(prompt[None], len(toks))
    ref = torch.as_tensor(np.asarray(toks, np.int32)[None], device=eng.device)
    for t in range(step):
        logits = eng.step(ref[:, t], caches).logits
    lf = logits[0].float()
    return float((lf[int(toks[step])] - lf[int(other[step])]).abs()
                 / lf.abs().max())


def against_generate(name: str, eng, workload, served, max_new: int,
                     tol: float) -> dict:
    """Each request of a serve run against ``generate`` of its prompt
    alone: its tokens equal up to a first difference at a near-tie (the
    two logits within ``tol`` of the largest).  Returns {uid: (first
    differing step, gap)} of the requests that part."""
    parted = {}
    for req, r in zip(workload(), served.results):
        g = eng.generate(np.asarray(req.tokens)[None], max_new=max_new)
        d = np.nonzero(g.tokens[0] != r.tokens)[0]
        if d.size:
            gap = logit_near_tie(eng, np.asarray(req.tokens), g.tokens[0],
                                 r.tokens, int(d[0]))
            if gap > tol:
                fail(f"{name} request {r.uid} (prompt {req.prompt_len}): "
                     f"token {int(r.tokens[d[0]])} at step {int(d[0])} "
                     f"against generate's {int(g.tokens[0, d[0]])}, logits "
                     f"{gap:.3e} of the largest apart (limit {tol})")
            parted[r.uid] = (int(d[0]), gap)
    return parted


def window_serve(dev, cell, counters) -> dict:
    """Gemma3-1B's engine (f32): 16 requests with prompts of 256..1024
    tokens (on both sides of the window of 512; each prefilled at its
    exact length), 4 slots, chunks of 8, 32 new, twice (identical; the
    second profiled for the card's idle share); each request's tokens
    against ``generate`` of its prompt alone, equal up to a first
    difference at an f32 near-tie (the two logits within LOGIT_TOL of
    the largest)."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.serve import synthetic_workload
    eng, cfg = cell["engine"], cell["cfg"]

    def workload():
        return synthetic_workload(16, cfg.vocab_size, max_new=32,
                                  min_len=256, max_len=1024, seed=7)

    def run():
        return eng.serve(workload(), num_slots=4, chunk=8, seed=0)

    g0 = eng.num_graphs
    for c in counters.values():
        c.reset()
    w0 = fd.window_launches.n
    a = run()
    launches = {n: c.n for n, c in counters.items()}
    window = fd.window_launches.n - w0
    b, busy_ms, _h2d, n_dev, wall = device_busy(run)
    idle = 1 - busy_ms / 1e3 / b.total_s
    if any(not np.array_equal(x.tokens, y.tokens)
           or not np.array_equal(x.logprobs, y.logprobs)
           for x, y in zip(a.results, b.results)):
        fail("gemma3-1b serve: two runs of one workload differ")
    if eng.num_graphs - g0 != 1:
        fail(f"gemma3-1b serve captured {eng.num_graphs - g0} graphs, "
             "expected 1")
    if min(launches["quant_matmul"], launches["flash_decode_attention"],
           window) <= 0:
        fail(f"gemma3-1b serve: a kernel was never launched: {launches}, "
             f"with a window {window}")
    parted = against_generate("gemma3-1b serve", eng, workload, a, 32,
                              LOGIT_TOL)
    ttft, lat = a.ttft_percentiles(), a.latency_percentiles()
    log(f"  gemma3-1b serve (16 requests, prompts "
        f"{min(r.prompt_len for r in a.results)}..."
        f"{max(r.prompt_len for r in a.results)}, 32 new, 4 slots, chunk 8):"
        f" {a.generated_tokens} tokens in {a.total_s:.3f} s = "
        f"{a.tokens_per_s:.2f} tok/s; decode {a.decode_s:.3f} s in "
        f"{a.chunks} chunks = {a.generated_tokens / a.decode_s:.2f} tok/s "
        f"(graph capture {a.capture_s:.3f} s of it); prefill "
        f"{a.prefill_s:.3f} s ({a.prefill_tokens} tokens, each prompt at "
        f"its exact length); TTFT p50/p95 {ttft[50.0] * 1e3:.1f}/"
        f"{ttft[95.0] * 1e3:.1f} ms; latency p50/p95 {lat[50.0] * 1e3:.1f}/"
        f"{lat[95.0] * 1e3:.1f} ms; KV cache "
        f"{a.cache_hbm_bytes / 2**20:.1f} MiB")
    log(f"  gemma3-1b serve: two runs identical; card busy "
        f"{busy_ms / 1e3:.3f} s of the profiled run's {b.total_s:.3f} s "
        f"(idle share {idle:.3f}; {n_dev} device ops, {wall:.1f} s with the "
        f"profiler); wrapper launches {launches}, {window} of flash-decode's"
        f" with a window; against generate one request at a time: "
        + (f"requests part at f32 near-ties {parted}" if parted
           else "every request's tokens identical"))
    return {"launches": launches, "eager_launches": {}, "window": window,
            "contiguous": a, "workload": workload}


def flash_window_timing(dev, gen, flush, B, H, KVH, hd, S, kind) -> dict:
    """Flash-decode's window mode over a local layer's wrapped ring (S =
    window slots, all valid, positions out of order) beside its plain
    version, its byte bound and SDPA with the window in its mask."""
    from repro_torch.kernels import decode_attention as fd
    args = flash_inputs(gen, dev, B, H, KVH, hd, S, S, kind, ring=True)
    cl = fd.launch_geometry(B * KVH * fd.group_splits(H // KVH), S,
                            fd.slots_per_warp(
        hd, args[1].element_size()), fd.cluster_capacity(
        dev, fd._KV_KIND[args[1].dtype], hd, H // KVH))
    return flash_timed(args, S, kind, flush,
                       f"flash_decode window B={B} H={H} KVH={KVH} "
                       f"(G={H // KVH}) hd={hd} ring S={S} = window, {kind},"
                       f" cluster {cl}")


def qmm_stack_timing(dev, gen, flush, st, M: int, label: str) -> dict:
    """Kernel 3 on a compressed E = 1 stack at M tokens, every token
    compensated, beside its plain version and its bound: the f32 CUDA-core
    bound on the decode path, the bf16 tensor-core bound (``tc_bound``)
    where the wrapper takes the tensor cores, with the f32 figure kept
    under ``bound_f32_ms`` as the prefill rows keep it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    qt = ops.stack_member(st, 0)
    K, N = qt.shape
    x = torch.randn((M, K), generator=gen, device=dev)
    args = (x, qt.planes, qt.scale, qt.zero, st.u[0], st.u_scale[0],
            st.v[0], st.v_scale[0], torch.ones((M,), device=dev), None)
    kw = dict(bits=qt.bits, group_size=qt.group_size)
    kt = time_ms(lambda: qm.quant_matmul(*args, require_kernel=True, **kw),
                 20, flush)
    pt = time_ms(lambda: qm.quant_matmul_plain(*args, **kw), 3, flush)
    allclose_report(f"quant_matmul {label}", qm.quant_matmul(
        *args, require_kernel=True, **kw), qm.quant_matmul_plain(
        *args, **kw), **FUSED_TOL)
    nb, ops_n = qmm_bytes_ops(M, K, N, qt.planes, st.pad_rank)
    bms, by = bound(nb, ops_n)
    out = dict(ms=_ms(f"quant_matmul {label}", kt),
               plain_ms=_ms(f"quant_matmul {label} plain", pt),
               bound_ms=bms, bound_by=by)
    if qm.qmm_path(M) == "splitk":
        cs, kch = qm.decode_splits(dev, M, K, N, st.pad_rank, qt.bits)
        geo = (f"{-(-M // qm.token_tile(M)) * -(-N // qm.QMM_BN)} clusters "
               f"of {cs} blocks x {kch} pack blocks")
        note = f"bound f32 CUDA cores {bms:.4f} ms ({by}"
    else:
        tms, tby = tc_bound(nb, ops_n)
        out.update(bound_ms=tms, bound_by=tby, bound_f32_ms=bms)
        geo = "tensor cores"
        note = (f"bound bf16 tensor cores x2 {tms:.4f} ms ({tby}), f32 "
                f"CUDA cores {bms:.4f} ms ({by}")
    log(f"  quant_matmul {label} M={M} K={K} N={N} bits={qt.bits} "
        f"R={st.pad_rank} ({geo}): kernel {_fmt(kt)}; plain {_fmt(pt)}; "
        f"{note}; {nb / 1e6:.2f} MB, {ops_n / 1e9:.3f} GFLOP)")
    return out


def window_phase(dev, counters):
    """Phase 13's three cells, Gemma3-1B's serve cell and the timings:
    flash-decode's window mode at both Gemma3 ring shapes and its G 7
    (Qwen2-7B) at that cell's decode shape, kernel 3 at Gemma3-27B's w1
    and w2 at M 4.  Returns (runs, served, {kernel: timing keys},
    {path: flash-decode launches with a window}, Gemma3-1B's engine,
    workload and contiguous serve for phase 14's paged run)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    keys = ("launches", "eager_launches", "compress_s", "prefill_ms",
            "decode_tok_s", "eager_tok_s", "profile")
    runs, served, window = {}, {}, {}
    flash, qmm = {}, {}
    for name in WINDOW_CELLS:
        t0 = time.perf_counter()
        log(f"  -- {name}")
        cell = window_cell(dev, name)
        runs[name] = {k: cell[k] for k in keys}
        window[name] = cell["window"]["graph"]
        window[f"{name}_eager"] = cell["window"]["eager"]
        if name == "gemma3_1b":
            sv = window_serve(dev, cell, counters)
            gemma = {"engine": cell["engine"], "workload": sv.pop("workload"),
                     "contiguous": sv.pop("contiguous")}
            served["gemma3_1b_serve"] = sv
            window["gemma3_1b_serve"] = sv.pop("window")
            timed = flash_window_timing(dev, gen, flush, 4, 4, 1, 256, 512,
                                        "f32")
        elif name == "gemma3_27b":
            timed = flash_window_timing(dev, gen, flush, 4, 32, 16, 128,
                                        1024, "bf16")
            for proj in ("w1", "w2"):
                qmm.update({f"gemma3_27b_{proj}_{k}": v for k, v in
                            qmm_stack_timing(dev, gen, flush,
                                             cell["stacks"][proj], 4,
                                             f"gemma3-27b {proj}").items()
                            if k != "bound_by"})
        else:
            timed = flash_slice_timing(dev, gen, flush, cell, "bf16")
        flash.update({f"{name}_{'window_' if name != 'qwen2_7b' else ''}"
                      f"{k}": v for k, v in timed.items() if k != "bound_by"})
        del cell
        torch.cuda.empty_cache()
        log(f"  {name} took {time.perf_counter() - t0:.1f} s")
    return runs, served, {"flash_decode_attention": flash,
                          "quant_matmul": qmm}, window, gemma


# ---------------------------------------------------------------------------
# phase 14: the stateful mixers (RecurrentGemma-9B's RG-LRU blocks and its
# G 16 local layers, xLSTM-125M's mLSTM / sLSTM blocks) and the paged
# cache's mixed plans, run after phase 13 (before phase 9)
# ---------------------------------------------------------------------------

# the depth cut: RecurrentGemma-9B's 38 layers go to two Griffin periods
# (4 recurrent, 2 local layers), every position of the pattern; its widths
# stay as published.  xLSTM-125M runs all 12 layers.
RECURRENTGEMMA_LAYERS = 6


def stateful_config(arch: str, layers):
    import dataclasses
    from repro_torch.models.transformer import layer_specs
    from repro_torch.registry import get_config
    full = get_config(arch)
    cut = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    kinds = [s.mixer for s in layer_specs(cut)]
    log(f"  config {cut.name}: d_model {cut.d_model}, heads {cut.num_heads}"
        f"/{cut.num_kv_heads} kv (G {cut.q_per_kv}), head_dim "
        f"{cut.head_dim}, d_ff {cut.d_ff}, vocab {cut.vocab_size}, lru "
        f"width {cut.lru_width}, conv width {cut.conv1d_width}, act "
        f"{cut.act}; mixers " + ", ".join(f"{kinds.count(k)} {k}" for k in
                                          dict.fromkeys(kinds))
        + (f" (window {cut.window_size})" if "local" in kinds else ""))
    log("  depth " + (f"{full.num_layers} layers, as published (no cut)"
                      if layers is None else
                      f"cut: {full.num_layers} -> {layers} layers (widths "
                      f"as published)"))
    return cut


def gate_share(eng, B: int, flush, step_ms: float) -> dict:
    """RecurrentGemma's RG-LRU gate matrices at decode: the two f32 (w, w)
    products of ``_lru_coeffs`` (u @ rg_wa, u @ rg_wx) of one recurrent
    layer at batch B, timed alone, times the recurrent layers, against
    the graph's device ms per step; and their byte bound."""
    rp = [lp["rglru"] for lp in eng.params["layers"] if "rglru" in lp]
    w = rp[0]["rg_wa"].shape[0]
    u = torch.randn((B, w), device=eng.device)
    t = time_ms(lambda: (u @ rp[0]["rg_wa"], u @ rp[0]["rg_wx"]), 20, flush)
    per = _ms("rg-lru gates", t)
    nb = 2 * w * w * 4 + 2 * B * w * 4 * 2
    bms, by = bound(nb, 4 * B * w * w)
    out = {"gates_ms_per_layer": per, "gates_bound_ms_per_layer": bms,
           "recurrent_layers": len(rp), "gates_ms_per_step": per * len(rp),
           "gates_share_of_step": per * len(rp) / step_ms}
    log(f"  rg-lru gate matrices (2 x f32 ({w}, {w}) at B={B}, "
        f"{nb / 1e6:.1f} MB a layer): {_fmt(t)} per layer, bound "
        f"{bms:.4f} ms ({by}); x {len(rp)} recurrent layers = "
        f"{per * len(rp):.4f} ms of the graph's {step_ms:.4f} ms device "
        f"step ({out['gates_share_of_step']:.3f})")
    return out


def stateful_cell(dev, name: str, counters) -> dict:
    """One cell of phase 14 through ``serve_slice`` (graph against eager,
    the profiles).  RecurrentGemma-9B (bf16, RECURRENTGEMMA_LAYERS deep):
    dense FFNs compressed to E = 1 stacks, 4 prompts of 2040 tokens and
    32 new (decode wraps the 2048-slot rings), the eager loop's launches
    checked exactly (flash-decode with a window once per local layer and
    step, kernel 3 three times per layer and forward), ``teacher_forced``
    against the impl='ref' engine under LOGIT_TOL_BF16, the gate
    matrices' share of the step.  xLSTM-125M (f32, 12 layers,
    unquantized: no TPU kernel lies on its path): 4 prompts of 512 tokens
    (two mLSTM chunks) and 32 new, then prefill-then-decode logits on the
    generated tokens against one forward pass over prompt and tokens
    (a single mLSTM chunk) within LOGIT_TOL of its largest."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.models import model as lm
    from repro_torch.models.transformer import (ExecContext,
                                                compress_dense_params,
                                                init_params, layer_specs)
    from repro_torch.serve.engine import ServeEngine
    rg = name == "recurrentgemma_9b"
    cfg = stateful_config("recurrentgemma-9b" if rg else "xlstm-125m",
                          RECURRENTGEMMA_LAYERS if rg else None)
    dtype = torch.bfloat16 if rg else torch.float32
    B, P, NEW = 4, 2040 if rg else 512, 32
    n_local = sum(s.mixer == "local" for s in layer_specs(cfg))
    log(f"  weights and activations in {dtype} (states f32); {B} prompts x "
        f"{P} tokens, {NEW} new")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    if rg:
        params, cfg = compress_dense_params(params, cfg)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    torch.cuda.empty_cache()
    stacks = params["layers"][0]["ffn"]["stacks"] if rg else None
    log(f"  init {t_init:.2f} s; compression {t_comp:.2f} s"
        + (f" ({cfg.num_layers} dense layers x 3 E=1 stacks; layer-0 ranks "
           f"{ {k: st.ranks[0] for k, st in stacks.items()} })" if rg else
           " (none: the technique does not apply, served unquantized)")
        + f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = np.random.default_rng(14).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    sv = serve_slice(dev, cfg, params, prompts, NEW,
                     {**counters, "flash_decode_window": fd.window_launches})
    eng, res = sv["engine"], sv["graph"]
    launches, eager = sv["launches"], sv["eager_launches"]
    window = {"graph": launches.pop("flash_decode_window"),
              "eager": eager.pop("flash_decode_window")}
    L = cfg.num_layers
    want = ({"flash_decode_attention": n_local * NEW,
             "quant_matmul": 3 * L * (NEW + 1), "fused_expert_matmul": 0}
            if rg else {k: 0 for k in eager})
    if eager != want or window["eager"] != n_local * NEW:
        fail(f"{name}: the eager loop's launches {eager}, with a window "
             f"{window['eager']}; expected {want}, with a window "
             f"{n_local * NEW}")
    if rg and (min(launches["quant_matmul"],
                   launches["flash_decode_attention"], window["graph"]) <= 0):
        fail(f"{name}: a kernel of the path was never launched: {launches},"
             f" with a window {window['graph']}")
    check_generation(res, B, NEW, cfg.vocab_size)
    if rg:
        log(f"  {name}: eager loop launches flash-decode (G {cfg.q_per_kv}"
            f", window {cfg.window_size}) {n_local} times a step, once per "
            f"local layer, and kernel 3 {3 * L} times a forward")
        ref = ServeEngine(cfg, params, quantized=True, kernel_impl="ref",
                          device=dev)
        teacher_forced(eng, ref, prompts, res.tokens, 0, dtype)
        del ref
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
        gates = gate_share(eng, B, flush,
                           sv["profile"]["graph"]["busy_ms"])
    else:
        log(f"  {name}: no TPU kernel lies on this path (the JAX package "
            f"serves xLSTM-125M unquantized, in plain XLA ops): wrapper "
            f"launches {launches}, eager {eager}")
        full = np.concatenate([prompts, res.tokens[:, :-1]], axis=1)
        one = lm.forward(params, torch.as_tensor(full, device=dev), cfg,
                         ExecContext(mode="train")).logits
        logits, caches = eng.prefill(prompts, NEW)
        worst = 0.0
        for t in range(NEW):
            ref = one[:, P - 1 + t].float()
            if not torch.isfinite(logits).all():
                fail(f"{name} step {t}: non-finite logits")
            d = float((logits.float() - ref).abs().max() / ref.abs().max())
            worst = max(worst, d)
            if d > LOGIT_TOL:
                fail(f"{name} step {t}: prefill-then-decode logits "
                     f"{d:.3e} of the largest from one forward pass "
                     f"(limit {LOGIT_TOL})")
            logits = eng.step(torch.as_tensor(res.tokens[:, t], device=dev),
                              caches).logits
        log(f"  {name} teacher-forced: prefill ({P // 256} mLSTM chunks of "
            f"256) and {NEW - 1} decode steps on the generated tokens "
            f"against one forward pass over {P + NEW - 1} tokens (one "
            f"chunk): max |dlogit| / max |logit| = {worst:.3e} (limit "
            f"{LOGIT_TOL})")
        gates = {}
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": eager, "window": window,
            "engine": eng, "stacks": stacks, "cfg": cfg, "gates": gates,
            "profile": sv["profile"], "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "eager_tok_s": sv["eager"].decode_tokens_per_s,
            "compress_s": t_comp}


def paged_mixed(dev, name: str, eng, workload, contiguous, counters) -> dict:
    """A mixed plan served at page 16 (global layers paged, local rings
    and recurrent states slot-indexed beside the pools): each request's
    tokens equal its contiguous run's, up to a first difference at an f32
    near-tie (the two logits within LOGIT_TOL of the largest); prefix
    reuse and speculation raise the JAX engine's ``ValueError``."""
    for c in counters.values():
        c.reset()
    paged = eng.serve(workload(), num_slots=4, chunk=8, seed=0, page_size=16)
    launches = {n: c.n for n, c in counters.items()}
    parted = {}
    for req, a, b in zip(workload(), paged.results, contiguous.results):
        d = np.nonzero(a.tokens != b.tokens)[0]
        if d.size:
            gap = logit_near_tie(eng, np.asarray(req.tokens), b.tokens,
                                 a.tokens, int(d[0]))
            if gap > LOGIT_TOL:
                fail(f"{name} paged request {a.uid}: token "
                     f"{int(a.tokens[d[0]])} at step {int(d[0])} against the"
                     f" contiguous run's {int(b.tokens[d[0]])}, logits "
                     f"{gap:.3e} of the largest apart")
            parted[a.uid] = (int(d[0]), gap)
    for kw in ({"page_size": 16, "prefix_cache": True},
               {"spec_k": 2, "drafter": "ngram"}):
        try:
            eng.serve(workload()[:1], num_slots=4, chunk=8, seed=0, **kw)
        except ValueError as e:
            log(f"  {name}: serve({kw}) refused: {e}")
        else:
            fail(f"{name}: serve({kw}) ran on a plan that is not all "
                 "global")
    log(f"  {name} paged (page 16, {len(paged.results)} requests, 4 slots):"
        f" {paged.generated_tokens} tokens in {paged.total_s:.3f} s = "
        f"{paged.tokens_per_s:.2f} tok/s; cache "
        f"{paged.cache_hbm_bytes / 2**20:.1f} MiB (contiguous "
        f"{contiguous.cache_hbm_bytes / 2**20:.1f} MiB); pages "
        f"{paged.page_report}; wrapper launches {launches}; against the "
        f"contiguous run: " + (f"requests part at f32 near-ties {parted}"
                               if parted else "every request's tokens "
                               "identical"))
    return {"launches": launches, "eager_launches": {}}


def stateful_phase(dev, counters, gemma):
    """Phase 14's two cells, RecurrentGemma's serve contiguous and paged,
    Gemma3-1B's phase-13 serve paged (``gemma``: its engine, workload and
    contiguous run), and kernel 3 timed at RecurrentGemma's w1 and w2 at
    M 4 (phase 4 times flash-decode at its G 16 ring).  Returns (runs,
    served, {kernel: timing keys}, {path: flash-decode launches with a
    window}, {gate keys})."""
    from repro_torch.serve import synthetic_workload
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    keys = ("launches", "eager_launches", "compress_s", "prefill_ms",
            "decode_tok_s", "eager_tok_s", "profile")
    runs, served, window, qmm = {}, {}, {}, {}
    t0 = time.perf_counter()
    log("  -- Gemma3-1B paged (phase 13's engine and 16 requests)")
    served["gemma3_1b_paged"] = paged_mixed(
        dev, "gemma3-1b", gemma["engine"], gemma["workload"],
        gemma["contiguous"], counters)
    log(f"  gemma3-1b paged took {time.perf_counter() - t0:.1f} s")
    gates = {}
    for name in ("recurrentgemma_9b", "xlstm_125m"):
        t0 = time.perf_counter()
        log(f"  -- {name}")
        cell = stateful_cell(dev, name, counters)
        runs[name] = {k: cell[k] for k in keys}
        window[name] = cell["window"]["graph"]
        window[f"{name}_eager"] = cell["window"]["eager"]
        if name == "recurrentgemma_9b":
            gates = cell["gates"]
            eng, cfg = cell["engine"], cell["cfg"]

            def workload():
                return synthetic_workload(8, cfg.vocab_size, max_new=16,
                                          min_len=1024, max_len=2040,
                                          seed=9)
            for c in counters.values():
                c.reset()
            contiguous = eng.serve(workload(), num_slots=4, chunk=8, seed=0)
            served["recurrentgemma_serve"] = {
                "launches": {n: c.n for n, c in counters.items()},
                "eager_launches": {}}
            # batch 1 against the serve's batch 4, both in bf16: a near-tie
            # is two logits within the bf16 protocol's limit
            parted = against_generate("recurrentgemma-9b serve", eng,
                                      workload, contiguous, 16,
                                      LOGIT_TOL_BF16)
            log(f"  recurrentgemma-9b serve (8 requests of "
                f"{min(r.prompt_len for r in contiguous.results)}..."
                f"{max(r.prompt_len for r in contiguous.results)} tokens, "
                f"16 new, 4 slots, chunk 8): {contiguous.generated_tokens} "
                f"tokens in {contiguous.total_s:.3f} s = "
                f"{contiguous.tokens_per_s:.2f} tok/s; decode "
                f"{contiguous.decode_s:.3f} s; prefill "
                f"{contiguous.prefill_s:.3f} s ({contiguous.prefill_tokens} "
                f"tokens, each prompt at its exact length); against generate"
                f" one request at a time: "
                + (f"requests part at bf16 near-ties {parted}" if parted
                   else "every request's tokens identical"))
            served["recurrentgemma_paged"] = paged_mixed(
                dev, "recurrentgemma-9b", eng, workload, contiguous,
                counters)
            for proj in ("w1", "w2"):
                qmm.update({f"recurrentgemma_9b_{proj}_{k}": v for k, v in
                            qmm_stack_timing(dev, gen, flush,
                                             cell["stacks"][proj], 4,
                                             f"recurrentgemma-9b {proj}"
                                             ).items() if k != "bound_by"})
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {name} took {time.perf_counter() - t0:.1f} s")
    return runs, served, {"quant_matmul": qmm}, window, gates


# ---------------------------------------------------------------------------
# phase 15: training and the last of the model zoo (DeepSeek-MoE-16B's
# train step, kill and resume; Whisper-base's encoder and cross-attention;
# Qwen2-VL-7B's M-RoPE), run after phase 14 (before phase 9)
# ---------------------------------------------------------------------------

# the depth cuts: DeepSeek-MoE-16B's 28 layers to 3 (layer 0 dense and 2
# MoE layers at full width: ~1.68e9 f32 parameters, ~34 GB with their
# gradients, master copy and moments); Qwen2-VL-7B's 28 to 4, as Qwen2-7B
# in phase 13 (its widths as published)
TRAIN_LAYERS = 3
QWEN2_VL_LAYERS = 4
# Qwen2-VL's prompts: 32 text tokens, a 12 x 16 grid of image stub tokens
# (Qwen2-VL's image-pad id), 32 text tokens
VL_TEXT, VL_GRID, VL_IMAGE_ID = 32, (12, 16), 151655
# fused (bf16 cotangents) against plain cross entropy at the train cell's
# size: tests/test_fused_xent.py's limits
XENT_LOSS_TOL, XENT_GRAD_REL = 1e-4, 2e-2
# the kill-and-resume cell on the card against the same run on the CPU:
# relative |dloss| per step
RESUME_CPU_TOL = 1e-5


class PrebuiltBatches:
    """A ``SyntheticLM``'s batches drawn before the run, served by step as
    ``train`` asks for them, so that a step's time leaves out the host's
    draw (``train``'s default draws each batch inside the timed step)."""

    def __init__(self, data, steps: int):
        self._batches = [data.batch(s) for s in range(steps)]

    def batch(self, step: int):
        return self._batches[step]


def mrope_positions(text_a: int, grid, text_b: int) -> np.ndarray:
    """(3, S) Qwen2-VL rope index ([arXiv:2409.12191]; ``get_rope_index``
    in HF transformers) of ``text_a`` text tokens, a ``grid`` (h, w) image
    block, then ``text_b`` text tokens: text has t = h = w; the block has
    t constant and h, w the grid offsets from the next free id; text
    after the block resumes at the largest id + 1."""
    gh, gw = grid
    t = list(range(text_a))
    h, w = list(t), list(t)
    for r in range(gh):
        for c in range(gw):
            t.append(text_a)
            h.append(text_a + r)
            w.append(text_a + c)
    nxt = max(t + h + w) + 1
    for i in range(text_b):
        t.append(nxt + i)
        h.append(nxt + i)
        w.append(nxt + i)
    return np.asarray([t, h, w], np.int32)


def history_line(h) -> str:
    return " ".join(f"{x['step']}:{x['loss']:.6f}/{x['grad_norm']:.4f}"
                    for x in h)


def train_cell(dev) -> dict:
    """(a) The trainer at full width: DeepSeek-MoE-16B cut to
    TRAIN_LAYERS, f32, ``train()`` on SyntheticLM batches of (4, 1024),
    TrainConfig(total_steps=8, warmup_steps=1, loss_chunk=512) (two
    padded chunks), each layer recomputed in the backward pass.  Twice:
    run 1 on batches drawn before it (the device's step), run 2 with
    ``train``'s default data, which draws each batch inside the timed
    step (what the CLI runs); every loss finite and the histories equal
    bit for bit.  Then one step under the profiler, and REPRO_XENT=plain
    against fused at this size."""
    import dataclasses
    import os
    from repro_torch.config import TrainConfig
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.model import lm_loss
    from repro_torch.models.transformer import (ExecContext, init_params,
                                                layer_specs)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.registry import get_config
    from repro_torch.train import train
    from repro_torch.train.microbatch import value_and_grad
    from repro_torch.tree import tree_leaves
    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    B, S = 4, 1024
    tcfg = TrainConfig(total_steps=8, warmup_steps=1, loss_chunk=512)
    log(f"  config {cfg.name}: d_model {cfg.d_model}, {cfg.moe.num_experts} "
        f"experts top-{cfg.moe.top_k} of {cfg.moe.d_expert}, "
        f"{cfg.moe.num_shared_experts} shared, dense layer 0 (d_ff "
        f"{cfg.d_ff}), vocab {cfg.vocab_size}; depth cut: "
        f"{full.num_layers} -> {cfg.num_layers} layers "
        f"{[s.ffn for s in layer_specs(cfg)]}; f32; batches {B} x {S}; "
        f"{tcfg}")
    t0 = time.perf_counter()
    data = PrebuiltBatches(SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, batch_size=B, seq_len=S,
        seed=tcfg.seed)), tcfg.total_steps)
    draw_s = (time.perf_counter() - t0) / tcfg.total_steps
    log(f"  {tcfg.total_steps} batches drawn before run 1: "
        f"{draw_s * 1e3:.1f} ms per batch on the host")
    hists, peaks = [], []
    n_params = 0
    for run, run_data in enumerate((data, None)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(cfg, tcfg, data=run_data, log_every=0,
                    batch_shape=(B, S), device=dev)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        n_params = sum(t.numel() for t in tree_leaves(res.state.params))
        hists.append(res.history)
        log(f"  run {run + 1}: {time.perf_counter() - t0:.2f} s (init "
            f"included), peak device memory {peaks[-1]:.2f} GiB; step:"
            f"loss/grad-norm {history_line(res.history)}")
        del res
    for h in hists[0]:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train: non-finite loss or grad norm at step {h['step']}")
    key = [[(h["loss"], h["grad_norm"], h["lr"]) for h in hist]
           for hist in hists]
    if key[0] != key[1]:
        fail(f"train: two runs differ: {key[0]} vs {key[1]}")
    dts = [h["dt"] for h in hists[0][1:]]
    step_s = float(np.median(dts))
    dts_d = [h["dt"] for h in hists[1][1:]]
    step_d = float(np.median(dts_d))
    log(f"  train: the two runs' loss, grad-norm and lr histories equal bit "
        f"for bit; {n_params / 1e9:.4f}e9 parameters; medians of steps "
        f"2-{tcfg.total_steps}: batches drawn before (run 1) "
        f"{step_s * 1e3:.1f} ms, {B * S / step_s:.1f} tokens/s (each "
        f"{[round(d * 1e3, 1) for d in dts]}); train()'s default, the "
        f"draw inside the step (run 2) {step_d * 1e3:.1f} ms, "
        f"{B * S / step_d:.1f} tokens/s (each "
        f"{[round(d * 1e3, 1) for d in dts_d]})")
    # one step under the profiler, from a fresh state
    step_fn, _ = make_train_step(cfg, tcfg, device=dev)
    params = init_params(cfg, tcfg.seed, torch.float32, dev)
    state = TrainState(params, adamw_init(params))
    state, _ = step_fn(state, data.batch(0))
    kernels, wall = profiled(lambda: step_fn(state, data.batch(1)))
    busy = sum(ms for _, ms in kernels)
    log(f"  train step profile: wall {wall * 1e3:.1f} ms with the profiler "
        f"on, device busy {busy:.1f} ms (sum of kernels), idle share "
        f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}, {len(kernels)} kernels; "
        f"top 8 by device time:")
    log_top(kernels, 1, "step")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # fused against plain cross entropy at this size, same parameters
    ctx = ExecContext(mode="train", remat=True)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0).items()}
    vg = value_and_grad(lambda p, b: lm_loss(p, b, cfg, ctx,
                                             loss_chunk=tcfg.loss_chunk))
    out = {}
    for mode in ("plain", "fused"):
        os.environ["REPRO_XENT"] = mode
        try:
            (loss, _), grads = vg(params, batch)
        finally:
            os.environ.pop("REPRO_XENT", None)
        out[mode] = (float(loss), grads)
    dl = abs(out["plain"][0] - out["fused"][0])
    worst = max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
                for a, b in zip(tree_leaves(out["fused"][1]),
                                tree_leaves(out["plain"][1])))
    if not (dl < XENT_LOSS_TOL and worst < XENT_GRAD_REL):
        fail(f"train: fused against plain cross entropy: |dloss| {dl:.3e} "
             f"(limit {XENT_LOSS_TOL}), max |dgrad| / max |grad| "
             f"{worst:.3e} (limit {XENT_GRAD_REL})")
    log(f"  REPRO_XENT=plain vs fused: loss {out['plain'][0]:.6f} vs "
        f"{out['fused'][0]:.6f} (|d| {dl:.3e}, limit {XENT_LOSS_TOL}), "
        f"worst leaf max |dgrad| / max |grad| {worst:.3e} (limit "
        f"{XENT_GRAD_REL})")
    del out, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_s * 1e3, "tok_s": B * S / step_s,
            "step_ms_default_data": step_d * 1e3,
            "tok_s_default_data": B * S / step_d, "draw_ms": draw_s * 1e3,
            "peak_gib": max(peaks), "busy_ms": busy, "wall_ms": wall * 1e3}


def resume_cell(dev) -> None:
    """(b) Kill and resume on the card: the reduced DeepSeek-MoE config,
    a FailureInjector at step 5 of 10, then a run from the checkpoint
    directory: its steps repeat the uninterrupted run's bit for bit, and
    the uninterrupted run is within RESUME_CPU_TOL of the same run on the
    CPU (the same initial parameters)."""
    import tempfile
    from repro_torch.config import TrainConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.registry import get_config
    from repro_torch.train import FailureInjector, train
    from repro_torch.tree import tree_map
    cfg = get_config("deepseek-moe-16b", reduced=True)
    tcfg = TrainConfig(total_steps=10, checkpoint_every=5, warmup_steps=2,
                       lr=1e-3, loss_chunk=0)
    cpu_params = init_params(cfg, tcfg.seed, torch.float32, "cpu")

    def init_on(d):
        return lambda seed: tree_map(lambda t: t.to(d, copy=True),
                                     cpu_params)
    kw = dict(log_every=0, batch_shape=(4, 64))
    t0 = time.perf_counter()
    ref = train(cfg, tcfg, init_fn=init_on(dev), device=dev, **kw)
    with tempfile.TemporaryDirectory() as ckpt:
        try:
            train(cfg, tcfg, init_fn=init_on(dev), device=dev,
                  checkpoint_dir=ckpt, failure=FailureInjector(5), **kw)
            fail("resume: the injected failure did not stop the run")
        except RuntimeError as e:
            if "injected failure at step 5" not in str(e):
                raise
        res = train(cfg, tcfg, init_fn=init_on(dev), device=dev,
                    checkpoint_dir=ckpt, **kw)
    if res.resumed_from != 5 or [h["step"] for h in res.history] != \
            list(range(5, 10)):
        fail(f"resume: resumed from {res.resumed_from}, steps "
             f"{[h['step'] for h in res.history]}")
    got = [(h["loss"], h["grad_norm"]) for h in res.history]
    want = [(h["loss"], h["grad_norm"]) for h in ref.history[5:]]
    if got != want:
        fail(f"resume: resumed history {got} differs from the uninterrupted "
             f"{want}")
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train(cfg, tcfg, init_fn=init_on("cpu"), device="cpu", **kw)
    worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(ref.history, cpu.history))
    if not worst <= RESUME_CPU_TOL:
        fail(f"resume: the card's losses are {worst:.3e} (relative) from "
             f"the CPU's (limit {RESUME_CPU_TOL}): "
             f"{history_line(ref.history)} vs {history_line(cpu.history)}")
    log(f"  kill at step 5 of 10 and resume ({cfg.name}, batches 4 x 64): "
        f"resumed from step 5, its 5 steps equal the uninterrupted run's "
        f"bit for bit ({gpu_s:.2f} s for the three runs); against the "
        f"CPU's run ({time.perf_counter() - t0:.2f} s) max relative "
        f"|dloss| {worst:.3e} (limit {RESUME_CPU_TOL}); card "
        f"{history_line(ref.history)}")


def step_loop(dev, cfg, params, batch, caches, NEW, counters, impl="auto",
              tokens=None, mrope_next=None):
    """``make_prefill_step`` on ``batch``, then NEW ``make_serve_step``
    steps (an eager loop), each fed its greedy token or ``tokens[:, i]``
    (teacher forcing); ``mrope_next``: the first decode position of each
    of M-RoPE's three streams (t = h = w from there on).  Returns (logits
    of the prefill and each step, the tokens fed, wrapper launches in the
    prefill and per step, prefill s, decode s)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    pre, _ = make_prefill_step(cfg, quantized=True, kernel_impl=impl,
                               device=dev)
    step, _ = make_serve_step(cfg, quantized=True, kernel_impl=impl,
                              device=dev)
    B = batch["tokens"].shape[0]

    def counts():
        return {n: c.n for n, c in counters.items()}
    n0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre(params, caches, batch)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    n1 = counts()
    outs, fed, per_step = [logits], [], []
    t0 = time.perf_counter()
    for i in range(NEW):
        tok = (outs[-1].argmax(-1).to(torch.int32) if tokens is None
               else tokens[:, i])
        fed.append(tok)
        sb = {"tokens": tok[:, None]}
        if mrope_next is not None:
            sb["mrope_pos"] = torch.full((3, B, 1), mrope_next + i,
                                         dtype=torch.int32, device=dev)
        a = counts()
        lg, caches = step(params, caches, sb)
        per_step.append({n: c.n - a[n] for n, c in counters.items()})
        outs.append(lg)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    return (outs, torch.stack(fed, dim=1),
            {n: n1[n] - n0[n] for n in n0}, per_step, pre_s, dec_s)


def hold_to_ref(name: str, outs, ref_outs, fed, tol: float) -> None:
    """Each step's logits within ``tol`` x max |ref logit|; the kernel
    run's greedy token equal to the reference's argmax unless the two
    tokens' reference logits are within ``tol`` x max |logit| (a
    near-tie)."""
    worst, ties = 0.0, 0
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite logits at step {i}")
        scale = b.abs().amax(dim=-1)
        d = (a - b).abs().amax(dim=-1)
        worst = max(worst, float((d / scale).max()))
        if bool((d > tol * scale).any()):
            fail(f"{name}: step {i} max |dlogit| / max |logit| "
                 f"{float((d / scale).max()):.3e} (limit {tol})")
        if i < fed.shape[1]:
            mine, theirs = fed[:, i].long(), b.argmax(-1)
            for r in torch.nonzero(mine != theirs)[:, 0].tolist():
                gap = float(b[r, theirs[r]] - b[r, mine[r]])
                if gap > tol * float(scale[r]):
                    fail(f"{name}: step {i} row {r}: token {int(mine[r])} "
                         f"where the reference's argmax {int(theirs[r])} "
                         f"leads by {gap:.3e}")
                ties += 1
    log(f"  {name} vs impl='ref' (teacher-forced): max |dlogit| / max "
        f"|logit| {worst:.3e} (limit {tol}); tokens equal but for {ties} "
        f"near-ties")


def whisper_cell(dev, counters, flush, gen) -> tuple:
    """(c) Whisper-base, no cut: 6 + 6 layers, d 512, 1500 frames, f32,
    batch 4, frame embeddings from a seed, prompts of 64 tokens, decoder
    FFNs as 3-bit E = 1 stacks of rank 16; make_prefill_step then 32
    greedy make_serve_step steps (eager), against a kernel_impl='ref' run;
    kernel 2 once per layer and step (G 1, hd 64) and kernel 3 twice per
    layer and forward (3 bits); then one unquantized train step with the
    frames, and the kernels timed at its shapes.  Returns (path entry,
    {kernel: timing keys})."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_caches, init_params)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.registry import get_config
    cfg = get_config("whisper-base")
    e = cfg.encoder
    B, P, NEW = 4, 64, 32
    log(f"  config {cfg.name}: decoder {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads (G "
        f"{cfg.q_per_kv}), hd {cfg.head_dim}, d_ff {cfg.d_ff} (plain "
        f"{cfg.act} MLP), vocab {cfg.vocab_size}, sinusoidal positions, "
        f"tied; encoder {e.num_layers} layers, d {e.d_model}, "
        f"{e.source_len} frames; {cfg.quant.bits}-bit E = 1 stacks of "
        f"rank {cfg.quant.rank_budget}; no cut; f32; {B} prompts x {P} "
        f"tokens, {NEW} new")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.float32, dev)
    qparams, cfg_q = compress_dense_params(params, cfg)
    torch.cuda.synchronize()
    stacks = qparams["layers"][0]["ffn"]["stacks"]
    log(f"  init + compression {time.perf_counter() - t0:.2f} s; layer-0 "
        f"ranks { {k: st.ranks[0] for k, st in stacks.items()} }")
    rng = np.random.default_rng(15)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, P)),
                              dtype=torch.int32, device=dev)
    frames = torch.randn((B, e.source_len, e.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(15))
    batch = {"tokens": prompts, "enc_embeds": frames}

    def caches():
        return init_caches(cfg_q, B, P + NEW, torch.float32, dev)
    for c in counters.values():
        c.reset()
    outs, fed, pre_n, per_step, pre_s, dec_s = step_loop(
        dev, cfg_q, qparams, batch, caches(), NEW, counters)
    launches = {n: c.n for n, c in counters.items()}
    want = {"flash_decode_attention": cfg.num_layers,
            "quant_matmul": 2 * cfg.num_layers, "fused_expert_matmul": 0}
    if any(s != want for s in per_step) or pre_n != {
            **want, "flash_decode_attention": 0}:
        fail(f"whisper: launches per step {per_step[0]} (prefill {pre_n}); "
             f"expected {want} a step and kernel 3 only at prefill")
    ref, _, _, _, _, _ = step_loop(dev, cfg_q, qparams, batch, caches(), NEW,
                                   {}, impl="ref", tokens=fed)
    hold_to_ref("whisper-base f32", outs, ref, fed, LOGIT_TOL)
    # timed: the same loop again (kernels loaded, cross caches rewritten)
    _, _, _, _, pre_s, dec_s = step_loop(dev, cfg_q, qparams, batch,
                                         caches(), NEW, {})
    log(f"  whisper-base: prefill (encoder + decoder, {B} x {P} tokens over "
        f"{e.source_len} frames) {pre_s * 1e3:.2f} ms; eager decode "
        f"{dec_s / NEW * 1e3:.3f} ms a step = {B * NEW / dec_s:.2f} tok/s; "
        f"launches a step {per_step[0]}, prefill {pre_n}")
    # one unquantized train step with the frames (the step updates the
    # parameters in place, which qparams shares outside the FFNs: last)
    del qparams, ref, outs
    step_fn, _ = make_train_step(cfg, TrainConfig(total_steps=1,
                                                  warmup_steps=1,
                                                  loss_chunk=0),
                                 device=dev)
    t0 = time.perf_counter()
    _, m = step_fn(TrainState(params, adamw_init(params)), batch)
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and gn > 0):
        fail(f"whisper train step: loss {loss}, grad norm {gn}")
    log(f"  whisper-base train step (unquantized, the frames through the "
        f"encoder): loss {loss:.4f}, grad norm {gn:.4f}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    del params, m, step_fn
    # the kernels at Whisper's shapes: kernel 2 (4, 8, 8, 64) at S 128 and
    # 2048, every slot valid, f32; kernel 3 at 3 bits on its stacks
    flash, qmm = {}, {}
    for S in (128, 2048):
        args = flash_inputs(gen, dev, B, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, S, S, "f32")
        flash.update({f"whisper_s{S}_{k}": v for k, v in flash_timed(
            args, None, "f32", flush, f"flash_decode whisper B={B} H=8 KVH=8"
            f" (G=1) hd=64 S={S} f32").items() if k != "bound_by"})
    for proj in ("w1", "w2"):
        for M in (4, 256):
            qmm.update({f"whisper_{proj}_m{M}_{k}": v for k, v in
                        qmm_stack_timing(dev, gen, flush, stacks[proj], M,
                                         f"whisper {proj}").items()})
    gc.collect()
    torch.cuda.empty_cache()
    return ({"launches": launches, "eager_launches": launches,
             "prefill_ms": pre_s * 1e3, "decode_tok_s": B * NEW / dec_s},
            {"flash_decode_attention": flash, "quant_matmul": qmm})


def qwen2_vl_cell(dev, counters) -> dict:
    """(d) Qwen2-VL-7B at full width, depth cut to QWEN2_VL_LAYERS, bf16,
    batch 4: prompts of 32 text tokens, a 12 x 16 grid of image stub
    tokens and 32 text tokens at Qwen2-VL's rope-index positions; 32
    decode steps at (3, B, 1) positions against a bf16 'ref' run
    (LOGIT_TOL_BF16); then the ServeEngine's text path (no positions:
    1-D RoPE) against the step builders at t = h = w positions, token for
    token.  Returns the path entries."""
    import dataclasses
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_caches, init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine, bucket_len
    full = get_config("qwen2-vl-7b")
    cfg = dataclasses.replace(full, num_layers=QWEN2_VL_LAYERS)
    B, NEW = 4, 32
    P = 2 * VL_TEXT + VL_GRID[0] * VL_GRID[1]
    log(f"  config {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads (G {cfg.q_per_kv}), hd {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE (t, h, w "
        f"sections 16, 24, 24), QKV biases (seeded nonzero); depth cut: "
        f"{full.num_layers} -> {cfg.num_layers} layers; bf16; {B} prompts "
        f"x {P} tokens ({VL_TEXT} text, a {VL_GRID[0]} x {VL_GRID[1]} "
        f"image grid, {VL_TEXT} text), {NEW} new")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(29)
    for lp in params["layers"]:
        for b in ("bq", "bk", "bv"):
            t = lp["attn"][b]
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.5)
    qparams, cfg_q = compress_dense_params(params, cfg)
    del params
    torch.cuda.synchronize()
    log(f"  init + compression {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(16)
    toks = rng.integers(2, VL_IMAGE_ID, (B, P)).astype(np.int32)
    toks[:, VL_TEXT:VL_TEXT + VL_GRID[0] * VL_GRID[1]] = VL_IMAGE_ID
    prompts = torch.as_tensor(toks, device=dev)
    pos3 = torch.as_tensor(mrope_positions(VL_TEXT, VL_GRID, VL_TEXT),
                           device=dev)[:, None].expand(3, B, P).contiguous()
    nxt = int(pos3.max()) + 1
    L = bucket_len(P + NEW + 1)     # the engine's bucket for this run

    def caches():
        return init_caches(cfg_q, B, L, torch.bfloat16, dev)
    for c in counters.values():
        c.reset()
    outs, fed, pre_n, per_step, pre_s, dec_s = step_loop(
        dev, cfg_q, qparams, {"tokens": prompts, "mrope_pos": pos3},
        caches(), NEW, counters, mrope_next=nxt)
    launches = {n: c.n for n, c in counters.items()}
    want = {"flash_decode_attention": cfg.num_layers,
            "quant_matmul": 3 * cfg.num_layers, "fused_expert_matmul": 0}
    if any(s != want for s in per_step) or pre_n != {
            **want, "flash_decode_attention": 0}:
        fail(f"qwen2-vl: launches per step {per_step[0]} (prefill {pre_n});"
             f" expected {want} a step and kernel 3 only at prefill")
    ref, _, _, _, _, _ = step_loop(dev, cfg_q, qparams,
                                   {"tokens": prompts, "mrope_pos": pos3},
                                   caches(), NEW, {}, impl="ref",
                                   tokens=fed, mrope_next=nxt)
    hold_to_ref("qwen2-vl-7b bf16 (grid positions)", outs, ref, fed,
                LOGIT_TOL_BF16)
    log(f"  qwen2-vl-7b: prefill {pre_s * 1e3:.2f} ms (first run); eager "
        f"decode {dec_s / NEW * 1e3:.3f} ms a step = {B * NEW / dec_s:.2f} "
        f"tok/s; launches a step {per_step[0]}, prefill {pre_n}")
    del ref, outs
    # the text path: the engine passes no positions (1-D RoPE), the step
    # builders t = h = w; the same kernels on the same caches' length
    flat = torch.arange(P, dtype=torch.int32, device=dev).expand(3, B, P) \
        .contiguous()
    _, flat_fed, _, _, _, _ = step_loop(
        dev, cfg_q, qparams, {"tokens": prompts, "mrope_pos": flat},
        caches(), NEW, {}, mrope_next=P)
    for c in counters.values():
        c.reset()
    eng = ServeEngine(cfg_q, qparams, quantized=True, device=dev)
    res = eng.generate(toks, max_new=NEW)
    text_launches = {n: c.n for n, c in counters.items()}
    if not np.array_equal(res.tokens, flat_fed.cpu().numpy()):
        fail("qwen2-vl: ServeEngine's text path gave other tokens than the "
             "step builders at t = h = w positions")
    log(f"  qwen2-vl-7b text path: ServeEngine.generate (graph) = the step "
        f"builders at t = h = w positions, {B} x {NEW} tokens equal; "
        f"{res.decode_tokens_per_s:.2f} tok/s with the decode graph; "
        f"launches {text_launches}")
    del eng, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"qwen2_vl_7b": {"launches": launches, "eager_launches": launches,
                            "prefill_ms": pre_s * 1e3,
                            "decode_tok_s": B * NEW / dec_s},
            "qwen2_vl_text": {"launches": text_launches,
                              "eager_launches": {},
                              "decode_tok_s": res.decode_tokens_per_s}}


def train_phase(dev, counters) -> tuple:
    """Phase 15: (a) the trainer at full width, (b) kill and resume, (c)
    Whisper-base, (d) Qwen2-VL-7B.  Returns (served paths, {kernel:
    timing keys}, the train cell's numbers)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(37)
    t0 = time.perf_counter()
    log("  -- (a) the trainer: DeepSeek-MoE-16B at full width")
    tr = train_cell(dev)
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("  -- (b) kill and resume")
    resume_cell(dev)
    log(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("  -- (c) Whisper-base")
    wh, table = whisper_cell(dev, counters, flush, gen)
    log(f"  (c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("  -- (d) Qwen2-VL-7B")
    served = {"whisper_base": wh, **qwen2_vl_cell(dev, counters)}
    log(f"  (d) took {time.perf_counter() - t0:.1f} s")
    return served, table, tr


# ---------------------------------------------------------------------------
# phase 9: the entry points (compress CLI -> artifact -> serve CLI)
# ---------------------------------------------------------------------------

QWEN3_ARCH = "qwen3-moe-30b-a3b"
# the depth cut: 48 layers are ~122 GB of f32 parameters; the allocation
# tables (an HQQ and a 768 x 768 float64 eigenvalue problem per expert,
# projection and candidate width) cost ~14 s per layer on an H100 (SXM,
# 700 W), so 10 layers keep the phase near 210 s
QWEN3_LAYERS = 10


def qwen3_config():
    import dataclasses
    from repro_torch.registry import get_config
    full = get_config(QWEN3_ARCH)
    cut = dataclasses.replace(full, num_layers=QWEN3_LAYERS)
    m, q = cut.moe, cut.moe.quant
    log(f"  config {cut.name}: d_model {cut.d_model}, heads {cut.num_heads}"
        f"/{cut.num_kv_heads} kv (G {cut.q_per_kv}), head_dim "
        f"{cut.head_dim}, experts {m.num_experts} top-{m.top_k}, d_expert "
        f"{m.d_expert}, router_norm_topk {m.router_norm_topk}, vocab "
        f"{cut.vocab_size}, tied embeddings {cut.tie_embeddings}, bits "
        f"{q.bits}, group {q.group_size}, rank_budget {q.rank_budget}, "
        f"top_n {q.top_n_restore}; f32")
    log(f"  depth cut: {full.num_layers} -> {cut.num_layers} layers "
        f"(widths as published)")
    return cut


def same_stacks(a, b) -> bool:
    """Two stacks-by-layer lists with equal meta, tensors and
    ``dequantize_all``, bit for bit."""
    fields = ("scale", "zero", "u", "v", "u_scale", "v_scale")
    for la, lb in zip(a, b):
        if list(la) != list(lb):
            return False
        for proj in la:
            x, y = la[proj], lb[proj]
            if (x.bits, x.group_size, tuple(x.shape), x.ranks, x.pad_rank,
                    x.factor_bits, x.expert_bits) != \
                    (y.bits, y.group_size, tuple(y.shape), y.ranks,
                     y.pad_rank, y.factor_bits, y.expert_bits):
                return False
            if not all(torch.equal(p, q) for p, q in zip(x.planes, y.planes)):
                return False
            if not all(torch.equal(getattr(x, f), getattr(y, f))
                       for f in fields):
                return False
            if not torch.equal(x.dequantize_all(), y.dequantize_all()):
                return False
    return len(a) == len(b)


def plan_fused_cases(dev, gen, stacks, cfg) -> float:
    """Kernel 1 on the allocated plan's stacks as compressed (heterogeneous
    widths in their container, the plan's true ranks, its pad_rank): w1
    and w2 of the layer with the widest container and of the layer with
    the largest pad_rank, on top-k dispatch at decode (T 4) and at an
    admission (T 512), both main-kernel paths forced, against the plain
    version in f64.  Returns the largest |diff|."""
    from repro_torch.kernels import quant_matmul as qm
    worst = 0.0
    wide = max(range(len(stacks)), key=lambda li: stacks[li]["w1"].bits)
    ranked = max(range(len(stacks)), key=lambda li: max(
        st.pad_rank for st in stacks[li].values()))
    for li, proj in [(li, p) for li in sorted({wide, ranked})
                     for p in ("w1", "w2")]:
        st = stacks[li][proj]
        E, K, N = st.shape
        eb, ranks = st.meta_tensors()
        kw = dict(bits=st.bits, group_size=st.group_size)
        for T in (4, 512):
            xe, me, ge, rows = dispatch_like(gen, dev, E, T, K,
                                             cfg.moe.top_k,
                                             cfg.moe.quant.top_n_restore)
            args = (xe, st.planes, st.scale, st.zero, st.u, st.u_scale,
                    st.v, st.v_scale, me, ge if proj == "w2" else None,
                    None, eb, ranks, rows)
            ref = qm.fused_expert_matmul_plain(xe.double(), *args[1:], **kw)
            for path in ("simt", "mma"):
                got = qm._launch_fused(path, *args, **kw)
                name = (f"fused qwen3 plan layer {li} {proj} path={path} "
                        f"E={E} K={K} N={N} T={T} container {st.bits} "
                        f"pad_rank {st.pad_rank} distinct ranks "
                        f"{sorted(set(st.ranks))} live experts "
                        f"{int((rows > 0).sum())}")
                mx = allclose_report(name, got, ref, **FUSED_TOL)
                worst = max(worst, mx)
                log(f"  ok  {name}  max|diff| {mx:.3e}")
            del xe, me, ge, args, got, ref
    torch.cuda.empty_cache()
    return worst


def log_plan(plan, stacks) -> None:
    ps = plan.summary()
    log(f"  plan: spent {ps['spent_bytes'] / 2**20:.2f} MiB of "
        f"{ps['budget_bytes'] / 2**20:.2f} MiB, mean bits "
        f"{ps['mean_bits']:.4f} {ps['bits_hist']}, mean rank "
        f"{ps['mean_rank']:.2f}, predicted weighted err "
        f"{plan.predicted_err:.6f}")
    from collections import Counter
    for li in (0, len(stacks) - 1):
        for proj, st in stacks[li].items():
            eb = st.expert_bits or (st.bits,) * len(st.ranks)
            log(f"    layer {li} {proj}: container {st.bits} bits, experts "
                f"by bits {dict(sorted(Counter(eb).items()))}, by rank "
                f"{dict(sorted(Counter(st.ranks).items()))}, pad_rank "
                f"{st.pad_rank}")


def entry_phase(dev, counters) -> dict:
    """Qwen3-MoE-30B-A3B at its published widths, depth cut to
    QWEN3_LAYERS, f32, through the system's own entry points: the
    compress CLI's ``run`` (calibrate, allocate under 0.9 of the uniform
    reference bytes, compress, write the artifact into a temporary
    directory), then the serve CLI's ``run`` booting that artifact
    (offload, 16 requests on 4 slots, chunks of 8, prompts of 256..512
    tokens, 32 new, LRU 32 of 128 experts).  Held: the loaded stacks equal
    the in-memory ones bit for bit; serving them in memory gives the same
    tokens, traces, reports and per-request bytes; teacher-forced logits
    against impl='ref'; kernel 1 on the plan's stacks on both paths in
    f64.  Then kernel 1 and flash-decode (G 8) timed at these shapes."""
    import tempfile
    from repro_torch.launch import compress as compress_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.transformer import (apply_compressed_stacks,
                                                init_params)
    from repro_torch.serve import ServeEngine, synthetic_workload
    cfg = qwen3_config()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="qwen3_artifact_") as tmp:
        art = str(Path(tmp) / "artifact")
        cargs = compress_cli.build_parser().parse_args(
            ["--arch", QWEN3_ARCH, "--out", art, "--full-config",
             "--budget-frac", "0.9"])
        t0 = time.perf_counter()
        cres = compress_cli.run(cfg, cargs)
        compress_s = time.perf_counter() - t0
        sec, man, plan = cres["seconds"], cres["manifest"], cres["plan"]
        mem_stacks = cres["stacks_by_layer"]
        disk = (Path(art) / "artifact.npz").stat().st_size
        log(f"  compress CLI: {compress_s:.2f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in sec.items())
            + f"; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
            f"artifact {man['n_tensors']} tensors, {man['bytes'] / 2**20:.1f}"
            f" MiB of tensors, {disk / 2**20:.1f} MiB on disk; wire bytes "
            f"{cres['wire_bytes'] / 2**20:.2f} MiB; routing-weighted "
            f"restoration error {cres['weighted_restoration_err']:.6f}")
        log_plan(plan, mem_stacks)
        del cres
        torch.cuda.empty_cache()

        sargs = serve_cli.build_parser().parse_args(
            ["--arch", QWEN3_ARCH, "--full-config", "--offload",
             "--artifact", art, "--requests", "16", "--slots", "4",
             "--chunk", "8", "--prompt-len", "512", "--max-new", "32",
             "--cache-experts", "32"])
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        sres = serve_cli.run(cfg, sargs)
        serve_s = time.perf_counter() - t0
        launches = {n: c.n for n, c in counters.items()}
    eng, st_a, loaded = sres["engine"], sres["stats"], sres["stacks_by_layer"]
    load_s = sres["load_s"]
    del sres
    for name in ("fused_expert_matmul", "flash_decode_attention"):
        if launches.get(name, 0) <= 0:
            fail(f"qwen3 serve: {name} was never launched: {launches}")
    check_bytes("qwen3 serve (artifact)", st_a)
    serve_line("qwen3 serve from the artifact", st_a)
    log(f"  serve CLI from the artifact: {serve_s:.2f} s in all, the "
        f"artifact loaded and checked in {load_s:.2f} s; graphs "
        f"{eng.num_graphs}; busy share {st_a.busy_frac:.3f}, goodput "
        f"{st_a.goodput_tokens_per_s:.2f} tok/s, KV cache "
        f"{st_a.cache_hbm_bytes_per_token / 2**10:.1f} KiB/token; wrapper "
        f"launches {launches}")
    if not same_stacks(loaded, mem_stacks):
        fail("the artifact's stacks differ from the in-memory stacks")
    log("  the loaded stacks equal the in-memory ones bit for bit "
        "(meta, planes, scales, zeros, factors, dequantize_all)")

    # the same workload served from the in-memory stacks
    params = init_params(cfg, 0, torch.float32, dev)
    qparams, cfg_q = apply_compressed_stacks(params, cfg, mem_stacks)
    del params
    torch.cuda.empty_cache()
    twin = ServeEngine(cfg_q, qparams, quantized=True, device=dev)
    twin.attach_offload(mem_stacks, policy="ours", cache_capacity=32)
    st_b = twin.serve(synthetic_workload(16, cfg.vocab_size, max_new=32,
                                         min_len=256, max_len=512, seed=0),
                      num_slots=4, chunk=8, seed=0)
    if not same_serve(st_a, st_b):
        fail("qwen3: serving the artifact differs from serving the "
             "in-memory stacks")
    serve_line("qwen3 serve from the in-memory stacks", st_b)
    log("  artifact serve = in-memory serve (tokens, traces, offload "
        "report, per-request bytes)")
    del twin, qparams, mem_stacks
    torch.cuda.empty_cache()

    # teacher-forced against impl='ref' on the artifact engine
    B, P, NEW = 4, 256, 32
    prompts = np.random.default_rng(3).integers(
        2, cfg.vocab_size, (B, P)).astype(np.int32)
    res = eng.generate(prompts, max_new=NEW)
    check_generation(res, B, NEW, cfg.vocab_size)
    ref = ServeEngine(eng.cfg, eng.params, quantized=True, kernel_impl="ref",
                      device=dev)
    teacher_forced(eng, ref, prompts, res.tokens, len(loaded), torch.float32)
    del ref
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(17)
    worst = plan_fused_cases(dev, gen, loaded, cfg)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    sl = {"cfg": eng.cfg, "B": B, "P": P, "NEW": NEW, "stacks": loaded}
    fused, _ = fused_timing(dev, gen, flush, sl, "qwen3", False)
    flash = flash_slice_timing(dev, gen, flush, sl, "f32")
    # serve's (4, 1024) bucket: 512-token prompts and 32 new
    flash1024 = flash_slice_timing(dev, gen, flush, dict(sl, P=700), "f32")
    flash.update({f"s1024_{k}": v for k, v in flash1024.items()
                  if k != "bound_by"})
    log(f"  qwen3 serve: {st_a.tokens_per_s:.2f} tok/s, "
        f"{st_a.offload_report['bytes_per_token'] / 1e6:.4f} wire MB/token, "
        f"hit rate {st_a.offload_report['hit_rate']:.4f}; kernel 1 w1 at "
        f"decode {fused['ms']:.4f} ms (bound {fused['bound_ms']:.4f}); "
        f"flash-decode G 8 S 512 {flash['ms']:.4f} ms (bound "
        f"{flash['bound_ms']:.4f}, SDPA {flash['library_ms']:.4f}), S 1024 "
        f"{flash['s1024_ms']:.4f} ms (bound {flash['s1024_bound_ms']:.4f}, "
        f"SDPA {flash['s1024_library_ms']:.4f})")
    del eng, loaded
    torch.cuda.empty_cache()
    return {"launches": launches, "eager_launches": {}, "max_err": worst,
            "fused": fused, "flash": flash}


def profiled(fn):
    """Run ``fn`` and synchronise under the profiler.  Returns ([(kernel
    name, device ms)], host-clock s): each device kernel the profiler saw,
    once, read from its raw events (as ``device_busy`` does: the per-event
    Python post-processing of an xLSTM prefill's ~75000 kernels and their
    host events took tens of seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA], wall


# the port's kernels by the names of their device functions: kernel 1
# (its pre-pass and either main kernel), kernel 2, kernel 3
KERNEL_NAMES = {"fused_expert_matmul": r"fused_expert|fused_mma",
                "flash_decode_attention": r"flash_decode",
                "quant_matmul": r"qmm_"}


# ---------------------------------------------------------------------------
# phase 16: expert-parallel serving on a mesh of ranks (gloo, every rank on
# cuda:0), after phase 15 and before phase 9
# ---------------------------------------------------------------------------

# DeepSeek-MoE-16B's depth on the mesh: a dense layer 0 and 3 MoE layers
EP_DEEPSEEK_LAYERS = 4


def slice_args(args, lo: int, hi: int):
    """Experts ``[lo, hi)`` of one fused-expert case's arguments (the rank
    cap is shared): what a rank of an expert-parallel mesh passes kernel 1
    for its slice, per-expert widths and ranks included."""
    out = []
    for i, a in enumerate(args):
        if a is None or i == 10:
            out.append(a)
        elif isinstance(a, tuple):
            out.append(tuple(p[lo:hi] for p in a))
        else:
            out.append(a[lo:hi])
    return out


def local_slice_cases(dev, gen) -> dict:
    """Phase 16 (a): kernel 1 on each shard's E/ep experts (ep 2 and 4) with
    the shard's own expert_bits and ranks, against the same rows of the
    full-E call (bit for bit, or within FUSED_TOL with the largest
    difference recorded) and, on both main-kernel paths forced, against
    the plain version in f64: Mixtral-8x7B's w1 and w2 (E 8, heterogeneous
    widths in a 3-bit container) at C 4 and 1024, DeepSeek-MoE-16B's w1 (E
    64, top-6 dispatch) at C 4."""
    from repro_torch.kernels import quant_matmul as qm
    worst_plain = worst_full = 0.0
    bit_equal = True
    cases = [("mixtral w1", 8, 4096, 14336, C) for C in (4, 1024)]
    cases += [("mixtral w2", 8, 14336, 4096, C) for C in (4, 1024)]
    cases += [("deepseek w1", 64, 2048, 1408, 4)]
    for name, E, K, N, C in cases:
        if E == 64:
            xe, me, ge, rows = dispatch_like(gen, dev, 64, C, K, 6, 3)
            args = list(random_stack_inputs(gen, dev, 64, 1, K, N, 1024, 2,
                                            False, "full", True))
            args[0], args[8], args[9], args[13] = xe, me, None, rows
        else:
            args = list(random_stack_inputs(
                gen, dev, E, C, K, N, 256, 3, gated=name.endswith("w2"),
                rank_mode="full", hetero=True, with_rows=C == 4))
        bits = 3 if E == 8 else 2
        full = qm.fused_expert_matmul(*args, bits=bits, group_size=64,
                                      require_kernel=True)
        for ep in (2, 4):
            el = E // ep
            for s in range(ep):
                sl = slice_args(args, s * el, (s + 1) * el)
                got = qm.fused_expert_matmul(*sl, bits=bits, group_size=64,
                                             require_kernel=True)
                want = full[s * el:(s + 1) * el]
                same = torch.equal(got, want)
                bit_equal &= same
                mx = allclose_report(
                    f"{name} C={C} ep={ep} shard {s} vs the full-E rows",
                    got, want, **FUSED_TOL)
                worst_full = max(worst_full, mx)
                if ep == 2 and s == 1:
                    ref = qm.fused_expert_matmul_plain(
                        sl[0].double(), *sl[1:], bits=bits, group_size=64)
                    for path in ("simt", "mma"):
                        g = qm._launch_fused(path, *sl, bits=bits,
                                             group_size=64)
                        mp = allclose_report(
                            f"{name} C={C} ep=2 shard 1 path={path}", g, ref,
                            **FUSED_TOL)
                        worst_plain = max(worst_plain, mp)
                    del ref
            log(f"  ok  fused local slices {name} K={K} N={N} C={C} ep={ep}"
                f" (expert_bits per shard "
                f"{[args[11][s * el:(s + 1) * el].tolist() for s in range(ep)]}"
                f"): {'bit-equal to' if bit_equal else 'within FUSED_TOL of'}"
                f" the full-E call's rows, max |diff| {worst_full:.3e}; "
                f"forced paths vs f64 plain max |diff| {worst_plain:.3e}")
        del args, full
        torch.cuda.empty_cache()
    return {"max_abs_err": worst_plain, "slice_vs_full_max_diff": worst_full,
            "slice_bit_equal": bool(bit_equal)}


def ep_summary(st) -> dict:
    """Host-side figures of a ``ServeStats`` to compare across processes."""
    rep = st.offload_report
    return {"tokens": [r.tokens.tolist() for r in st.results],
            "results": st.results,
            "trace": st.router_trace, "plan_trace": st.plan_trace,
            "report": None if rep is None else {
                k: rep[k] for k in ("total_bytes", "tokens", "hit_rate",
                                    "per_shard_bytes", "ep",
                                    "compensator_bytes", "demand_bytes")},
            "shard_bytes": (None if st.shard_bytes is None
                            else st.shard_bytes.tolist()),
            "tok_s": st.tokens_per_s}


def ep_workload(vocab: int, seed: int):
    from repro_torch.serve import synthetic_workload
    return synthetic_workload(8, vocab, max_new=16, min_len=24, max_len=160,
                              seed=seed)


def ep_serve_cases(eng, meta_stacks, vocab: int, budget: float) -> dict:
    """Phase 16 (c)'s serves on one engine (a mesh engine, or the
    single-device one metering through ``attach_offload(ep=2)``): 8
    ragged requests on 4 slots, chunks of 8, LRU 8 of 8 per shard (no
    eviction), then a per_shard byte budget at LRU 2; on the mesh also
    paged at page 16 and greedy speculation at k 2."""
    from repro_torch.config import ControlConfig
    out = {}
    kw = {} if eng.mesh is not None else {"ep": 2}

    def offload(cap):
        eng.attach_offload(meta_stacks, policy="ours", cache_capacity=cap,
                           **kw)
        eng._controller = None

    offload(8)
    out["serve"] = ep_summary(eng.serve(ep_workload(vocab, 5), num_slots=4,
                                        chunk=8))
    offload(2)
    eng.attach_controller(ControlConfig(enabled=True, bytes_per_token=budget,
                                        budget_scope="per_shard"))
    out["per_shard"] = ep_summary(eng.serve(ep_workload(vocab, 6),
                                            num_slots=4, chunk=8))
    if eng.mesh is None:
        return out
    offload(8)
    out["paged"] = ep_summary(eng.serve(ep_workload(vocab, 5), num_slots=4,
                                        chunk=8, page_size=16))
    offload(8)
    out["spec"] = ep_summary(eng.serve(ep_workload(vocab, 5), num_slots=4,
                                       spec_k=2, drafter="ngram"))
    return out


def ep_rank(rank: int, jobs: list) -> list:
    """One rank of phase 16's mesh of 2 (gloo, cuda:0), running each job in
    turn ((b) + (c) for Mixtral-8x7B, then (d) for DeepSeek-MoE-16B) with
    ``ep_job``; the engines of a job are freed before the next."""
    from repro_torch.launch.mesh import make_serve_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    mesh = make_serve_mesh(2, backend="gloo", device=dev)
    outs = []
    for job in jobs:
        outs.append(ep_job(mesh, job, t0))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return outs


def ep_job(mesh, job: dict, t0: float) -> dict:
    """One model on the mesh: the seeded params, the artifact's slice of
    the experts, ``generate`` of the job's prompts (wrapper launches
    counted over it), the eager loop's collectives and memory, then the
    teacher-forced logits against a single-device engine on the same
    weights in this rank (``teacher_forced``: in bf16 one step of both
    from the same state), and with ``job['serve']`` phase (c)'s serves.
    A failed check exits the rank non-zero, which fails the run."""
    from repro_torch.calib import load_compression_artifact
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.transformer import (apply_compressed_stacks,
                                                init_params)
    from repro_torch.serve.engine import ServeEngine
    dev = mesh.device
    cfg, dtype = job["cfg"], job["dtype"]
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    local, _, _ = load_compression_artifact(job["art"], job["cfg_q"],
                                            device=dev,
                                            shard=(mesh.rank, 2))
    qp, cfg_q = apply_compressed_stacks(params, cfg, local)
    del params                  # the dense experts
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg_q, qp, quantized=True, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    boot_s = time.perf_counter() - t0
    prompts, NEW = job["prompts"], job["new"]
    eng.generate(prompts, max_new=2)              # warm-up: libraries, RoPE
    # the collectives of generate's own prefill: its mesh counters read
    # on both sides of the engine's prefill (gloo's calls return when
    # done, so the host clock holds them)
    marks = []
    prefill = eng.prefill

    def counted_prefill(*a, **kw):
        marks.append((mesh.comm_s, mesh.comm_calls))
        out = prefill(*a, **kw)
        marks.append((mesh.comm_s, mesh.comm_calls))
        return out

    eng.prefill = counted_prefill
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = (mesh.comm_s, mesh.comm_calls)
    for c in (qm.launches, fd.launches):
        c.reset()
    res = eng.generate(prompts, max_new=NEW)
    launches = {"fused_expert_matmul": qm.launches.n,
                "flash_decode_attention": fd.launches.n}
    c2 = (mesh.comm_s, mesh.comm_calls)
    del eng.prefill
    if len(marks) != 2:
        fail(f"generate ran {len(marks) // 2} prefills, expected 1")
    (a0, an), (b0, bn) = marks
    pre_s, pre_n = b0 - a0, bn - an
    dec_s = (c2[0] - c0[0]) - pre_s
    dec_n = (c2[1] - c0[1]) - pre_n
    out = {"rank": mesh.rank, "boot_s": boot_s, "tokens": res.tokens,
           "trace": res.router_trace, "logprobs": res.logprobs,
           "decode_tok_s": res.decode_tokens_per_s,
           "prefill_ms": res.prefill_s * 1e3, "launches": launches,
           "comm_ms_per_step": dec_s * 1e3 / NEW,
           "comm_calls_per_step": dec_n / NEW,
           "prefill_comm_ms": pre_s * 1e3, "prefill_comm_calls": pre_n,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "local_bits": {k: (s.expert_bits, s.ranks)
                          for k, s in local[0].items()}}
    # every expert on the card: the single-device engine, and the
    # metadata the offload stores read
    full, _, _ = load_compression_artifact(job["art"], job["cfg_q"],
                                           device=dev)
    qf, _ = apply_compressed_stacks(qp, cfg_q, full)
    ref = ServeEngine(cfg_q, qf, quantized=True, device=dev,
                      decode_graph=False)
    teacher_forced(eng, ref, prompts, res.tokens, len(full), dtype)
    out["ref"] = ref.generate(prompts, max_new=NEW)
    if job.get("serve"):
        out["serve"] = ep_serve_cases(eng, full, cfg.vocab_size,
                                      job["budget"])
        if mesh.rank == 0:
            out["single"] = ep_serve_cases(ref, full, cfg.vocab_size,
                                           job["budget"])
    return out


def first_divergence(a: np.ndarray, b: np.ndarray):
    """(step, row) of the first token where two (B, T) streams differ."""
    diff = np.argwhere(a != b)
    if not len(diff):
        return None
    first = diff[np.argmin(diff[:, 1])]
    return int(first[1]), int(first[0])


def generate_divergence(name: str, got: dict, want, tol: float) -> dict:
    """Rows of two greedy ``generate`` runs whose tokens or router traces
    differ: each must first differ where the two runs' probabilities of
    their own tokens agree within ``tol`` (``paged_divergence``'s near-tie
    rule).  ``got``: an ``ep_job`` result; ``want``: a GenerationResult.
    Returns {row: first differing step}."""
    from types import SimpleNamespace as NS

    def rows(tokens, logprobs, trace):
        return NS(results=[NS(uid=r, tokens=tokens[r], logprobs=logprobs[r],
                              trace=trace[:, :, r])
                           for r in range(tokens.shape[0])])

    return paged_divergence(name, rows(got["tokens"], got["logprobs"],
                                       got["trace"]),
                            rows(want.tokens, want.logprobs,
                                 want.router_trace), tol, False)


def check_ep_serve(name: str, got: dict, want: dict) -> None:
    """(c): the mesh's serves against the single-device engine's."""
    for key in ("serve", "per_shard"):
        g, w = got[key], want[key]
        if g["tokens"] != w["tokens"]:
            fail(f"{name} {key}: tokens differ from the single-device engine")
        if not np.array_equal(g["trace"], w["trace"]):
            fail(f"{name} {key}: router traces differ")
        if g["report"] != w["report"]:
            fail(f"{name} {key}: offload report {g['report']} != the single"
                 f"-device engine's {w['report']}")
        rep = g["report"]
        if rep["ep"] != 2 or sum(rep["per_shard_bytes"]) != \
                rep["total_bytes"] or g["shard_bytes"] != \
                rep["per_shard_bytes"]:
            fail(f"{name} {key}: per-shard bytes {rep['per_shard_bytes']} do"
                 f" not sum to {rep['total_bytes']}")
    if not np.array_equal(got["per_shard"]["plan_trace"],
                          want["per_shard"]["plan_trace"]):
        fail(f"{name}: the per_shard budget's plan trace differs")
    if len({str(p) for p in got["per_shard"]["plan_trace"]}) < 2:
        fail(f"{name}: the per_shard budget never moved the plan")
    # paged attention and the verify pass sum in other orders than the
    # contiguous decode step: a first divergence only at an f32 near-tie,
    # as phases 11 and 12 hold them on one device
    from types import SimpleNamespace as NS
    base = NS(results=got["serve"]["results"])
    parted = {key: paged_divergence(f"{name} {key}", base,
                                    NS(results=got[key]["results"]),
                                    NEAR_TIE, False)
              for key in ("paged", "spec")}
    if not parted["paged"] and got["paged"]["report"] != \
            got["serve"]["report"]:
        fail(f"{name}: paged serving on the mesh metered other bytes")
    r = got["serve"]["report"]
    log(f"  {name} serve (8 requests, 4 slots, chunk 8, LRU 8 of 8 per "
        f"shard): tokens, traces, hits ({r['hit_rate']:.4f}) and bytes equal"
        f" the single-device engine metering through attach_offload(ep=2): "
        f"total {r['total_bytes']} = per shard {r['per_shard_bytes']}; "
        f"per_shard budget: plan trace equal over "
        f"{len(got['per_shard']['plan_trace'])} chunks, per shard "
        f"{got['per_shard']['report']['per_shard_bytes']}; paged (page 16) "
        f"and speculative (k 2) = contiguous but for first divergences at "
        f"f32 near-ties {parted}; tok/s mesh "
        f"{got['serve']['tok_s']:.2f}, single-device eager "
        f"{want['serve']['tok_s']:.2f}")


def ep_line(name: str, r0: dict, r1: dict, base_tok_s: float) -> None:
    log(f"  {name} generate on the mesh (eager loop, gloo on cuda:0): "
        f"decode {r0['decode_tok_s']:.2f} tok/s (single-device eager "
        f"{base_tok_s:.2f}), prefill {r0['prefill_ms']:.2f} ms; collectives "
        f"{r0['comm_ms_per_step']:.3f} ms host per step "
        f"({r0['comm_calls_per_step']:.1f} calls), prefill "
        f"{r0['prefill_comm_ms']:.2f} ms ({r0['prefill_comm_calls']} "
        f"calls); peak device memory per rank {r0['peak_gib']:.2f} / "
        f"{r1['peak_gib']:.2f} GiB; rank start to engine "
        f"{r0['boot_s']:.2f} s; rank 0's launches {r0['launches']}")


def ep_phase(dev, mx_ref: dict) -> tuple:
    """Phase 16: (a) kernel 1 on local slices; (b) + (c) Mixtral-8x7B (f32,
    2 layers at full width, phase 3's weights through its artifact) on a
    2-rank gloo mesh: generate = phase 3's eager loop (tokens and traces),
    teacher-forced logits, tok/s, collectives, memory; serve, the
    per_shard budget, paged and speculative serving against the
    single-device engine; (d) DeepSeek-MoE-16B (bf16, EP_DEEPSEEK_LAYERS
    deep) on the mesh under the bf16 protocol, (d') its f32 twin under
    the f32 one; (e) the serve CLI with --mesh ep=2.  (b), (c) and (d)
    run on one mesh of 2 ranks, one start-up.  Returns (served paths, the kernel-1 and mesh figures)."""
    import dataclasses
    from repro_torch.calib import save_compression_artifact
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params)
    gen = torch.Generator(device=dev).manual_seed(16)
    t = time.perf_counter()
    fused = local_slice_cases(dev, gen)
    log(f"  (a) took {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    cfg = dataclasses.replace(deepseek_config(),
                              num_layers=EP_DEEPSEEK_LAYERS)
    log(f"  deepseek depth cut to {cfg.num_layers} (a dense layer 0 and "
        f"{cfg.num_layers - 1} MoE layers), widths as published, bf16")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    _, cfg_q, stacks = compress_moe_params(params, cfg)
    del params
    art = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    try:
        save_compression_artifact(art, cfg_q, stacks, seed=0)
        del stacks
        torch.cuda.empty_cache()
        log(f"  deepseek compressed and written in "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        jobs = [{"cfg": mx_ref["cfg"], "cfg_q": mx_ref["cfg_q"],
                 "dtype": torch.float32, "art": mx_ref["art"],
                 "prompts": mx_ref["prompts"],
                 "new": mx_ref["eager"].tokens.shape[1], "serve": True,
                 "budget": 2.0**20},
                {"cfg": cfg, "cfg_q": cfg_q, "dtype": torch.bfloat16,
                 "art": art, "prompts": np.random.default_rng(2).integers(
                     2, cfg.vocab_size, (4, 256)).astype(np.int32),
                 "new": 32}]
        # the same model and experts in f32: top-6 partials crossing
        # ranks held at LOGIT_TOL, and the tokens at f32 near-ties
        jobs.append(dict(jobs[1], dtype=torch.float32))
        (r0, d0, f0), (r1, d1, f1) = run_ranks(ep_rank, 2, backend="gloo",
                                               args=(jobs,))
    finally:
        shutil.rmtree(art, ignore_errors=True)
    log(f"  (b), (c), (d) and (d') on one mesh of 2 ranks took "
        f"{time.perf_counter() - t:.1f} s")
    eager = mx_ref["eager"]
    for r in (r0, r1):
        d = first_divergence(r["tokens"], eager.tokens)
        if d is not None:
            fail(f"mixtral ep2 rank {r['rank']}: tokens part from phase 3's "
                 f"eager loop at (step, row) {d}")
        if not np.array_equal(r["trace"], eager.router_trace):
            fail(f"mixtral ep2 rank {r['rank']}: router trace differs from "
                 "phase 3's eager loop")
    lp = float(np.abs(r0["logprobs"] - eager.logprobs).max())
    log(f"  (b) mixtral ep2: both ranks' tokens and router traces equal "
        f"phase 3's single-device eager loop ({eager.tokens.shape[0]} x "
        f"{eager.tokens.shape[1]}), max |dlogprob| {lp:.3e}; teacher-forced"
        f" against the single-device engine (above, both ranks); shard "
        f"experts of w1 {[r['local_bits']['w1'] for r in (r0, r1)]} (bits, "
        f"ranks)")
    ep_line("mixtral ep2", r0, r1, eager.decode_tokens_per_s)
    check_ep_serve("mixtral ep2", r0["serve"], r0["single"])
    check_ep_serve("mixtral ep2 rank 1", r1["serve"], r0["single"])
    if not np.array_equal(d1["tokens"], d0["tokens"]):
        fail("deepseek ep2: the ranks sampled different tokens")
    d = first_divergence(d0["tokens"], d0["ref"].tokens)
    log(f"  (d) deepseek ep2: teacher-forced against the single-device "
        f"engine within LOGIT_TOL_BF16 (above, both ranks); greedy tokens "
        + ("equal the single-device engine's" if d is None else
           f"part from the single-device engine's at (step, row) {d} "
           f"(bf16 sums over top-6 partials in another order)"))
    ep_line("deepseek ep2", d0, d1, d0["ref"].decode_tokens_per_s)
    if not np.array_equal(f1["tokens"], f0["tokens"]):
        fail("deepseek ep2 f32: the ranks sampled different tokens")
    parted = generate_divergence("deepseek ep2 f32", f0, f0["ref"],
                                 NEAR_TIE)
    log(f"  (d') deepseek ep2 f32 (same weights and experts): teacher-"
        f"forced against the single-device engine within LOGIT_TOL (above, "
        f"both ranks); greedy tokens and traces "
        + ("equal the single-device engine's" if not parted else
           f"equal the single-device engine's but for first divergences at "
           f"f32 near-ties {parted} (row: step)"))
    ep_line("deepseek ep2 f32", f0, f1, f0["ref"].decode_tokens_per_s)
    served = {"mixtral_ep2": {"launches": r0["launches"],
                              "eager_launches": {}},
              "deepseek_ep2": {"launches": d0["launches"],
                               "eager_launches": {}},
              "deepseek_ep2_f32": {"launches": f0["launches"],
                                   "eager_launches": {}}}
    figures = {}
    for name, a, b in (("mixtral", r0, r1), ("deepseek", d0, d1),
                       ("deepseek_f32", f0, f1)):
        figures[name] = {k: a[k] for k in (
            "decode_tok_s", "comm_ms_per_step", "peak_gib", "prefill_ms",
            "prefill_comm_ms")}
        figures[name]["peak_gib_rank1"] = b["peak_gib"]
        figures[name]["single_device_eager_tok_s"] = (
            eager.decode_tokens_per_s if name == "mixtral"
            else a["ref"].decode_tokens_per_s)

    t = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "mixtral-8x7b", "--requests", "6", "--slots", "2", "--chunk", "4",
           "--max-new", "8", "--offload", "--mesh", "ep=2",
           "--budget-scope", "per_shard", "--bytes-per-token", "20000",
           "--dist-backend", "gloo"]
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    for line in p.stdout.strip().splitlines():
        log(f"    cli: {line}")
    if p.returncode != 0 or "per-shard links (ep=2)" not in p.stdout:
        log(p.stderr[-3000:])
        fail(f"the serve CLI with --mesh ep=2 exited {p.returncode}")
    log(f"  (e) the serve CLI ({' '.join(cmd[2:])}) exited 0 in "
        f"{time.perf_counter() - t:.1f} s")
    fused["ep_figures"] = figures
    return served, fused


def log_top(kernels, per: int, what: str) -> None:
    """The 8 kernel names of ``profiled``'s kernels with the most device
    time, per ``what``."""
    ms_by_name = {}
    for name, ms in kernels:
        ms_by_name[name] = ms_by_name.get(name, 0.0) + ms
    for name, ms in sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms / per:8.4f} ms/{what}  {name[:100]}")


def profile_decode(eng, prompts, max_new: int, step_s: float,
                   steps: int = 4) -> dict:
    """Where a decode step's time goes: ``eng.decode`` over ``steps``
    steps of a prefill sized for ``max_new`` (the timed run's bucket, so
    its graph replays) under the profiler (graph replays on a graph engine, eager
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
    logits, caches = eng.prefill(prompts, max_new)
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
    ours = {name: sum(ms for n, ms in kernels if re.search(pat, n)) / steps
            for name, pat in KERNEL_NAMES.items()}
    out["ours_ms"] = ours
    log(f"  decode profile ({mode}): ms/step on the device by port kernel "
        + ", ".join(f"{n} {ms:.4f} ({ms / busy:.3f} of busy)"
                    for n, ms in ours.items()))
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

    keys = ("launches", "eager_launches", "compress_s", "prefill_ms",
            "decode_tok_s", "eager_tok_s", "profile")
    runs = {}
    log("== phase 3: serving slice")
    sl = slice_phase(dev)

    log("== phase 4: timing")
    table = timing_phase(dev, sl)
    table["fused_expert_matmul"]["launches_mma"] = sl["mma_launches"]
    runs["mixtral"] = {k: sl[k] for k in keys}
    mixtral = {k: sl[k] for k in ("engine", "stacks", "cfg")}
    # phase 16 serves these weights again on a mesh of ranks, which read
    # them from an artifact
    from repro_torch.calib import save_compression_artifact
    t0 = time.perf_counter()
    mx_ref = {"cfg": sl["cut"], "cfg_q": sl["cfg"], "prompts": sl["prompts"],
              "eager": sl["eager"],
              "art": tempfile.mkdtemp(prefix="chip_smoke_ep_")}
    save_compression_artifact(mx_ref["art"], sl["cfg"], sl["stacks"], seed=0)
    log(f"  phase 3's stacks written for phase 16 in "
        f"{time.perf_counter() - t0:.1f} s")
    del sl
    torch.cuda.empty_cache()

    log("== phase 5: dense slice (Llama-3.2-3B)")
    dl = dense_phase(dev)
    table.update(dense_timing(dev, dl))
    runs["llama"] = {k: dl[k] for k in keys}
    del dl
    torch.cuda.empty_cache()

    log("== phase 6: both slices in bf16")
    log("  -- Mixtral-8x7B, bf16")
    sl = slice_phase(dev, torch.bfloat16)
    runs["mixtral_bf16"] = {k: sl[k] for k in keys}
    del sl
    torch.cuda.empty_cache()
    log("  -- Llama-3.2-3B, bf16")
    dl = dense_phase(dev, torch.bfloat16)
    runs["llama_bf16"] = {k: dl[k] for k in keys}
    del dl
    torch.cuda.empty_cache()

    log("== phase 7: DeepSeek-MoE-16B in bf16")
    ds = deepseek_phase(dev)
    for name, extra in deepseek_timing(dev, ds).items():
        table[name].update(extra)
    table["fused_expert_matmul"]["deepseek_launches_mma"] = \
        ds["mma_launches"]
    runs["deepseek"] = {k: ds[k] for k in keys}

    log("== phase 8: continuous-batching serve() with offload metering and "
        "the bandwidth controller")
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    counters = {"fused_expert_matmul": qm.launches,
                "flash_decode_attention": fd.launches,
                "quant_matmul": qm.qmm_launches}
    t8 = time.perf_counter()
    log("  -- Mixtral-8x7B (phase 3's engine, f32)")
    served = {"mixtral_serve": serve_mixtral(dev, mixtral, counters)}
    log("  -- DeepSeek-MoE-16B (phase 7's engine, bf16)")
    served["deepseek_serve"] = serve_deepseek(dev, ds, counters)
    for name, sv in served.items():
        for kname in ("fused_expert_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    log("== phase 10: async expert streaming (on phase 8's weights, before "
        "phase 9)")
    t10 = time.perf_counter()
    log("  -- Mixtral-8x7B (phase 3's weights, f32)")
    streamed = {"mixtral_stream": stream_mixtral(
        dev, mixtral, served["mixtral_serve"], counters)}
    log("  -- DeepSeek-MoE-16B (phase 7's weights, bf16)")
    streamed["deepseek_stream"] = stream_deepseek(
        dev, ds, served["deepseek_serve"]["resident"], counters)
    for name, sv in streamed.items():
        for kname in ("fused_expert_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    link_gbs = streamed["deepseek_stream"].pop("link_gbs")
    served.update(streamed)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    log("== phase 11: the paged KV cache (on phase 8's engines, before "
        "phase 9)")
    t11 = time.perf_counter()
    log("  -- Mixtral-8x7B (phase 3's engine, f32)")
    paged = {"mixtral_paged": paged_mixtral(dev, mixtral, counters)}
    log("  -- DeepSeek-MoE-16B (phase 7's engine, bf16)")
    paged["deepseek_paged"] = paged_deepseek(
        dev, ds, served["deepseek_serve"]["resident"], counters, link_gbs)
    for name, sv in paged.items():
        for kname in ("fused_expert_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    served.update(paged)
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    log("== phase 12: speculative decoding (on phase 8's engines, before "
        "phase 9)")
    t12 = time.perf_counter()
    log("  -- Mixtral-8x7B (phase 3's engine, f32)")
    spec = {"mixtral_spec": spec_mixtral(dev, mixtral,
                                         served["mixtral_serve"], counters)}
    del mixtral
    torch.cuda.empty_cache()
    log("  -- DeepSeek-MoE-16B (phase 7's engine, bf16)")
    spec["deepseek_spec"] = spec_deepseek(
        dev, ds, served["deepseek_serve"]["resident"], counters)
    for name, sv in spec.items():
        for kname in ("fused_expert_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    table["flash_decode_attention"]["launches_multi_query"] = {
        name: sv.pop("multi") for name, sv in spec.items()}
    spec["deepseek_spec"].pop("idle")
    served.update(spec)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
    del ds
    torch.cuda.empty_cache()

    log("== phase 13: sliding-window models (Gemma3-1B, Gemma3-27B) and "
        "QKV biases (Qwen2-7B), before phase 9")
    t13 = time.perf_counter()
    wruns, wserved, wtable, wwindow, gemma = window_phase(dev, counters)
    runs.update(wruns)
    served.update(wserved)
    for name, extra in wtable.items():
        table[name].update(extra)
    table["flash_decode_attention"]["launches_window_by_path"] = wwindow
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")

    log("== phase 14: the stateful mixers (RecurrentGemma-9B, xLSTM-125M) "
        "and the paged cache's mixed plans, before phase 9")
    t14 = time.perf_counter()
    sruns, sserved, stable, swindow, gates = stateful_phase(dev, counters,
                                                            gemma)
    del gemma
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(sruns)
    served.update(sserved)
    for name, extra in stable.items():
        table[name].update(extra)
    table["flash_decode_attention"]["launches_window_by_path"].update(
        swindow)
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s; rg-lru gate "
        f"matrices {gates}")

    log("== phase 15: training (DeepSeek-MoE-16B at full width, kill and "
        "resume), Whisper-base's encoder and cross-attention, Qwen2-VL-7B's "
        "M-RoPE, before phase 9")
    t15 = time.perf_counter()
    tserved, ttable, trained = train_phase(dev, counters)
    for name, sv in tserved.items():
        for kname in ("quant_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    served.update(tserved)
    for name, extra in ttable.items():
        table[name].update(extra)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s; train step "
        f"{trained['step_ms']:.1f} ms, {trained['tok_s']:.1f} tokens/s "
        f"(batches drawn before), {trained['step_ms_default_data']:.1f} ms,"
        f" {trained['tok_s_default_data']:.1f} tokens/s (drawn in the step,"
        f" {trained['draw_ms']:.1f} ms per draw), peak "
        f"{trained['peak_gib']:.2f} GiB")

    log("== phase 16: expert-parallel serving on a mesh of 2 ranks (gloo, "
        "every rank on cuda:0), before phase 9")
    t16 = time.perf_counter()
    try:
        ep_served, ep_fused = ep_phase(dev, mx_ref)
    finally:
        shutil.rmtree(mx_ref["art"], ignore_errors=True)
    for name, sv in ep_served.items():
        for kname in ("fused_expert_matmul", "flash_decode_attention"):
            if sv["launches"].get(kname, 0) <= 0:
                fail(f"{name}: {kname} was never launched: {sv['launches']}")
    served.update(ep_served)
    errs["fused_expert_matmul"] = max(errs["fused_expert_matmul"],
                                      ep_fused.pop("max_abs_err"))
    table["fused_expert_matmul"].update(ep_fused)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

    log("== phase 9: the entry points: compress CLI -> artifact -> serve "
        "CLI (Qwen3-MoE-30B-A3B)")
    t9 = time.perf_counter()
    ep = entry_phase(dev, counters)
    served["qwen3_entry"] = ep
    errs["fused_expert_matmul"] = max(errs["fused_expert_matmul"],
                                      ep["max_err"])
    table["fused_expert_matmul"].update(
        {f"qwen3_{k}": v for k, v in ep["fused"].items()})
    table["flash_decode_attention"].update(
        {f"qwen3_{k}": v for k, v in ep["flash"].items() if k != "bound_by"})
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

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
    paths = {**runs, **served}
    for name, (path, replaces) in src.items():
        by_path = {run: r["launches"].get(name, 0)
                   for run, r in paths.items()}
        eager_by_path = {run: r["eager_launches"].get(name, 0)
                         for run, r in paths.items() if r["eager_launches"]}
        kernels.append(dict(name=name, route="cuda", source=path,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            launches_eager_by_path=eager_by_path,
                            max_abs_err=errs[name], **table[name]))
    for name, r in runs.items():
        ours = r["profile"]["graph"]["ours_ms"]
        log(f"  {name}: compression {r['compress_s']:.2f} s, prefill "
            f"{r['prefill_ms']:.2f} ms, decode {r['decode_tok_s']:.2f} "
            f"tok/s with the graph, {r['eager_tok_s']:.2f} eager; graph "
            f"decode step: host {r['profile']['graph']['host_ms']:.3f} ms, "
            f"device busy {r['profile']['graph']['busy_ms']:.3f} ms, idle "
            f"share {r['profile']['graph']['idle']:.3f}; port kernels ms/step "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in ours.items()))
    log(f"  total run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
