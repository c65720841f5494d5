#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # on a machine with an H100

Phases:
  1. preflight  the card's name and power limit; build the CUDA kernels
                from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a)
  2. kernels    hold each kernel against its plain PyTorch version on the
                card, at the shapes of the Mixtral-8x7B serving path
  3. slice      Mixtral-8x7B at its published widths, depth cut to 2
                layers, random f32 weights from a seeded generator:
                compress on the card, ``ServeEngine.generate`` through
                the kernels, and hold its teacher-forced logits and
                router choices against the same engine with impl='ref'
  4. timing     each kernel, its plain version and (where one exists) a
                PyTorch library call computing the same function, at
                decode shapes, beside its bound

It prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line; without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import json
import math
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

# kernel vs plain version, both f32 on the card: the sums run in another
# order (split over 8 warps and 64-row blocks, the dequant factored per
# block) over K <= 14336 terms, so |diff| <= 1e-3 + 1e-4 |ref| (the JAX
# package's fused-kernel parity tolerance)
FUSED_TOL = dict(atol=1e-3, rtol=1e-4)
# flash-decode: f32 online softmax in another order than softmax()
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
# served logits, kernel engine vs impl='ref' engine, f32 through 2
# layers: max |diff| <= LOGIT_TOL * max |ref logit|
LOGIT_TOL = 1e-3
# router choices may differ only where the two probabilities compared
# are this close (a near-tie flipped by f32 rounding)
NEAR_TIE = 1e-3


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

    ``device``: the median over calls of the summed durations of the
    kernels ``fn`` launched, from ``torch.profiler``'s CUDA trace (the
    flush kernel excluded); None if the trace holds no device time.
    ``wall``: CUDA events around each call, which also count the host's
    time to launch the call's kernels when the card waits on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        flush.bitwise_not_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    per_call = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.bitwise_not_()
            torch.cuda.synchronize()
            with torch.profiler.record_function("timed_call"):
                fn()
                torch.cuda.synchronize()
    # the annotation appears twice: on the host timeline (the window a
    # call's kernels are attributed to) and as a span on the device
    # timeline, which is not a kernel
    marks = [ev.time_range for ev in prof.events()
             if ev.name == "timed_call" and ev.device_type == DeviceType.CPU]
    kernels = {(ev.name, ev.time_range.start, ev.time_range.end): ev
               for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and ev.name != "timed_call"
               and "bitwise_not" not in ev.name}.values()
    for m in marks:
        per_call.append(sum(ev.time_range.elapsed_us() for ev in kernels
                            if m.start <= ev.time_range.start <= m.end))
    dev_ms = (float(np.median(per_call)) / 1e3
              if per_call and max(per_call) > 0 else None)
    return {"device": dev_ms, "wall": float(np.median(walls))}


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def random_stack_inputs(gen, dev, E, C, K, N, R, bits, gated, rank_mode,
                        hetero, with_rows=False):
    """Random kernel arguments of one fused-expert case; ``with_rows``
    gives each expert an occupied-slot count (one idle expert, one full)
    and zeroes the slots past it, as dispatch leaves them."""
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
    rows = None
    if with_rows:
        rows = rint(0, C + 1, (E,), torch.int32)
        rows[0], rows[1] = 0, C
        live = (torch.arange(C, device=dev)[None, :] < rows[:, None]).float()
        xe, me = xe * live[:, :, None], me * live
    return (xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge, cap,
            eb, ranks, rows)


def kernel_phase(dev):
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(1234)
    E = 8
    shapes = [(4096, 14336), (14336, 4096)]
    errs = {"fused_expert_matmul": 0.0, "flash_decode_attention": 0.0}
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

    B, H, KVH, hd, S = 4, 32, 8, 128, 512
    for kind in ("f32", "bf16", "int8"):
        for window, filled in ((None, S * 9 // 16), (S // 4, S * 9 // 16),
                               (None, 10)):
            q = torch.randn((B, H, hd), generator=gen, device=dev) \
                / math.sqrt(hd)
            k = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
            v = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
            ar = torch.arange(S, device=dev, dtype=torch.int32)
            pos = torch.where(ar < filled, ar, -1)[None].repeat(B, 1)
            cur = torch.full((B,), filled - 1, dtype=torch.int32, device=dev)
            ks = vs = None
            if kind == "bf16":
                k, v = k.bfloat16(), v.bfloat16()
            elif kind == "int8":
                from repro_torch.models.kvcache import _kv_quant
                k, ks = _kv_quant(k)
                v, vs = _kv_quant(v)
            got = fd.flash_decode_attention(q, k, v, pos, cur, ks, vs,
                                            window=window,
                                            require_kernel=True)
            ref = fd.flash_decode_attention_plain(q, k, v, pos, cur, ks, vs,
                                                  window=window)
            name = f"flash_decode kv={kind} window={window} filled={filled}"
            mx = allclose_report(name, got, ref, **DECODE_TOL)
            errs["flash_decode_attention"] = max(
                errs["flash_decode_attention"], mx)
            log(f"  ok  {name}  max|diff| {mx:.3e}")
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
    eng = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="auto",
                      device=dev)
    eng.generate(prompts[:, :16], max_new=2)          # warm-up
    qm.launches.reset()
    fd.launches.reset()
    res = eng.generate(prompts, max_new=NEW, seed=0)
    launches = {"fused_expert_matmul": qm.launches.n,
                "flash_decode_attention": fd.launches.n}
    log(f"  generate: {B} prompts x {P} tokens, {NEW} new tokens, "
        f"temperature 0: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{res.decode_s * 1e3:.2f} ms = {res.decode_tokens_per_s:.2f} tok/s"
        f"; launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
    profile_decode(eng, prompts, res.decode_s / NEW)
    toks = res.tokens
    if toks.shape != (B, NEW) or not np.all((toks >= 0)
                                            & (toks < cfg.vocab_size)):
        fail(f"generated tokens malformed: shape {toks.shape}")
    if not np.all(np.isfinite(res.logprobs)):
        fail("non-finite log-probs")
    n_moe = len(stacks)
    if res.router_trace.shape != (NEW, n_moe, B, cfg.moe.top_k):
        fail(f"router trace shape {res.router_trace.shape}")

    # teacher-forced: both engines read the kernel engine's tokens
    ref = ServeEngine(cfg_q, qparams, quantized=True, kernel_impl="ref",
                      device=dev)
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
    return {"launches": launches, "stacks": stacks, "cfg": cfg_q,
            "prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.decode_tokens_per_s,
            "compress_s": t_comp, "B": B, "P": P, "NEW": NEW}


# ---------------------------------------------------------------------------
# phase 4: timing at decode shapes
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
    dev = "not measured" if t["device"] is None else f"{t['device']:.4f} ms"
    return f"{dev} on the device ({t['wall']:.4f} ms between events)"


def _ms(name: str, t: dict) -> float:
    """The device time of the ``kernels`` line.  A trace without device
    time, or with more device time than a call takes between events (its
    kernels counted twice), is a failed measurement."""
    if t["device"] is None:
        fail(f"{name}: the profiler's trace holds no device time")
    if t["device"] > 1.5 * t["wall"]:
        fail(f"{name}: device time {t['device']:.4f} ms exceeds the "
             f"{t['wall']:.4f} ms between events")
    return t["device"]


def timing_phase(dev, sl):
    import torch.nn.functional as F
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
    # slots compensated
    for proj in ("w1", "w2"):
        st = sl["stacks"][0][proj]
        K = st.shape[1]
        for C in (B, B * sl["P"]):
            xe, me, ge, rows = dispatch_like(gen, dev, E, C, K,
                                             cfg.moe.top_k,
                                             cfg.moe.quant.top_n_restore)
            ge = ge if proj == "w2" else None
            eb, ranks = st.meta_tensors()
            args = (xe, st.planes, st.scale, st.zero, st.u, st.u_scale,
                    st.v, st.v_scale, me, ge, None, eb, ranks, rows)
            kw = dict(bits=st.bits, group_size=st.group_size)
            kt = time_ms(lambda: qm.fused_expert_matmul(
                *args, require_kernel=True, **kw), 10, flush)
            pt = time_ms(lambda: qm.fused_expert_matmul_plain(*args, **kw),
                         3, flush)
            nb, ops = fused_bytes_ops(xe, st, me, ge, rows)
            bms, by = bound(nb, ops)
            log(f"  fused {proj} E={E} C={C} K={K} N={st.shape[2]} "
                f"bits={st.bits} rows={rows.tolist()}: kernel {_fmt(kt)}; plain {_fmt(pt)}; "
                f"bound {bms:.4f} ms ({by}; {nb / 1e6:.2f} MB, "
                f"{ops / 1e9:.3f} GFLOP)")
            if proj == "w1" and C == B:
                table["fused_expert_matmul"] = dict(
                    ms=_ms("fused kernel", kt),
                    plain_ms=_ms("fused plain", pt), bound_ms=bms,
                    bound_by=by, library_ms=None)
            del xe, me, ge
    # flash decode at the slice's decode shape: f32 cache of bucket length
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = 1 << max(sl["P"] + sl["NEW"], 1).bit_length()
    filled = sl["P"] + sl["NEW"]
    q = torch.randn((B, H, hd), generator=gen, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=gen, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    pos = torch.where(ar < filled, ar, -1)[None].repeat(B, 1)
    cur = torch.full((B,), filled - 1, dtype=torch.int32, device=dev)
    kt = time_ms(lambda: fd.flash_decode_attention(
        q, k, v, pos, cur, require_kernel=True), 20, flush)
    pt = time_ms(lambda: fd.flash_decode_attention_plain(q, k, v, pos, cur),
                 20, flush)
    qs = q[:, :, None, :]
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
    lt = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kT, vT, attn_mask=mask, scale=1.0, enable_gqa=True), 20, flush)
    got = fd.flash_decode_attention(q, k, v, pos, cur, require_kernel=True)
    want = F.scaled_dot_product_attention(qs, kT, vT, attn_mask=mask,
                                          scale=1.0, enable_gqa=True)[:, :, 0]
    allclose_report("flash_decode vs SDPA", got, want, atol=1e-4, rtol=1e-4)
    nb = 2 * B * filled * KVH * hd * 4 + 4 * B * S + 4 * B + 8 * B * H * hd
    ops = 4 * B * H * filled * hd
    bms, by = bound(nb, ops)
    log(f"  flash_decode B={B} H={H} KVH={KVH} hd={hd} S={S} valid={filled} "
        f"f32: kernel {_fmt(kt)}; plain {_fmt(pt)}; SDPA {_fmt(lt)}; "
        f"bound {bms:.4f} ms ({by})")
    table["flash_decode_attention"] = dict(
        ms=_ms("flash-decode kernel", kt),
        plain_ms=_ms("flash-decode plain", pt), bound_ms=bms, bound_by=by,
        library_ms=_ms("SDPA", lt))
    return table


def profile_decode(eng, prompts, step_s: float, steps: int = 4) -> None:
    """Where a decode step's time goes: the device time of every kernel
    over ``steps`` profiled steps, against the host-clock time of a step
    with the profiler on and of ``step_s`` (a step of the unprofiled
    ``generate`` run); the card's idle share is 1 - device / step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    logits, caches = eng.prefill(prompts, steps + 1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = eng.step(tok, caches)
            tok = torch.argmax(out.logits, dim=-1).to(torch.int32)
            caches = out.caches
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {(ev.name, ev.time_range.start, ev.time_range.end): ev
               for ev in prof.events() if ev.device_type == DeviceType.CUDA}
    by_name = {}
    for ev in kernels.values():
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    wall_ms = wall * 1e3
    log(f"  decode profile, {steps} steps: device busy {busy / steps:.3f} "
        f"ms/step; host clock {step_s * 1e3:.3f} ms/step unprofiled (idle "
        f"share {1 - busy / steps / (step_s * 1e3):.3f}), {wall_ms / steps:.3f}"
        f" ms/step profiled; kernel launches/step {len(kernels) / steps:.1f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms / steps:8.4f} ms/step  {name[:100]}")


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
    for src in build.SOURCES:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {src}: {line.strip()}")

    log("== phase 2: kernels vs plain versions")
    errs = kernel_phase(dev)

    log("== phase 3: serving slice")
    sl = slice_phase(dev)

    log("== phase 4: timing")
    table = timing_phase(dev, sl)
    src = {"fused_expert_matmul": (
        "src/repro_torch/kernels/csrc/fused_expert.cu",
        "src/repro/kernels/quant_matmul.py:241"),
        "flash_decode_attention": (
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/decode_attention.py:73")}
    kernels = []
    for name, (path, replaces) in src.items():
        kernels.append(dict(name=name, route="cuda", source=path,
                            replaces=replaces,
                            launches=sl["launches"][name],
                            max_abs_err=errs[name], **table[name]))
    log(f"  slice: compression {sl['compress_s']:.2f} s, prefill "
        f"{sl['prefill_ms']:.2f} ms, decode {sl['decode_tok_s']:.2f} tok/s "
        f"(total run {time.perf_counter() - t_start:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
