"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with its reason, where no CUDA device
is visible (the CPU tier).  On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no JAX (``--noconftest`` skips the JAX test setup),
so it also runs where only PyTorch is installed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.quantize import PLANES
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import quant_matmul as qm

pytestmark = pytest.mark.cuda

FUSED_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fused_args(dev, E, C, K, N, R, bits, gated, cap, eb, seed, group=64):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rint(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dt)

    planes = tuple(rint(0, 256, (E, K * p // 8, N), torch.uint8)
                   for p, _ in PLANES[bits])
    scale = torch.rand((E, K // group, N), generator=g, device=dev) * 0.02
    zero = torch.rand((E, K // group, N), generator=g, device=dev) * 3
    u = rint(-127, 128, (E, K, R), torch.int8)
    v = rint(-127, 128, (E, R, N), torch.int8)
    us = torch.rand((E, 1, R), generator=g, device=dev) * 1e-3
    vs = torch.rand((E, R, 1), generator=g, device=dev) * 1e-3
    xe = torch.randn((E, C, K), generator=g, device=dev)
    me = (torch.rand((E, C), generator=g, device=dev) < 0.5).float()
    ge = torch.rand((E, C), generator=g, device=dev) if gated else None
    ranks = torch.tensor([R, R // 2, 0, R][:E], dtype=torch.int32,
                         device=dev)
    capt = None if cap is None else torch.tensor([cap], dtype=torch.int32,
                                                 device=dev)
    ebt = torch.tensor(eb, dtype=torch.int32, device=dev)
    return (xe, planes, scale, zero, u, us, v, vs, me, ge, capt, ebt, ranks)


def _with_rows(args, rows):
    """Zero x and the mask past each expert's occupied slots, as dispatch
    leaves them, and append the counts."""
    dev = args[0].device
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    c = args[0].shape[1]
    live = (torch.arange(c, device=dev)[None] < rows[:, None]).float()
    args = list(args)
    args[0] = args[0] * live[:, :, None]
    args[8] = args[8] * live
    return (*args, rows)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("c", [1, 3, 8, 21, 130, 300])
@pytest.mark.parametrize("path", [None, "simt", "mma"])
@pytest.mark.parametrize("group", [64, 128, 256])
def test_fused_kernel_matches_plain(dev, bits, c, path, group):
    """Each main kernel (path None: the one the wrapper takes by C) at any
    C, also where the wrapper would take the other one, with and without
    occupied-slot counts, in groups of one pack block, of two, and of all
    of K (per channel)."""
    eb = [bits, max(1, bits - 1), bits, bits]
    args = _fused_args(dev, 4, c, 256, 260, 48, bits,
                       gated=(c + group // 64) % 2 == 0,
                       cap=[None, 0, 17, 48][c % 4], eb=eb, seed=bits * c,
                       group=group)
    for a in (args, _with_rows(args, [c, c // 2, 0, min(c, 65)])):
        before = qm.launches.n
        if path is None:
            got = qm.fused_expert_matmul(*a, bits=bits, group_size=group,
                                         require_kernel=True)
        else:
            got = qm._launch_fused(path, *a, bits=bits, group_size=group)
        assert qm.launches.n == before + 1
        want = qm.fused_expert_matmul_plain(*a, bits=bits, group_size=group)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("n", [256, 1412])
@pytest.mark.parametrize("c", [1, 4, 37])
def test_fused_kernel_skips_empty_slots(dev, c, n):
    """rows[e] = occupied leading slots: tiles past it and idle experts
    give zeros without reading weights, as the plain version computes; at
    N 1412 (no multiple of 16 or 128: a last column tile of 4 columns) as
    at N 256."""
    args = list(_fused_args(dev, 4, c, 128, n, 32, 2, gated=True,
                            cap=None, eb=[2] * 4, seed=c))
    rows = torch.tensor([0, c, c // 2, 1], dtype=torch.int32, device=dev)
    live = (torch.arange(c, device=dev)[None] < rows[:, None]).float()
    args[0] = args[0] * live[:, :, None]
    args[8] = args[8] * live
    got = qm.fused_expert_matmul(*args, rows, bits=2, group_size=64,
                                 require_kernel=True)
    want = qm.fused_expert_matmul_plain(*args, rows, bits=2, group_size=64)
    full = qm.fused_expert_matmul(*args, bits=2, group_size=64,
                                  require_kernel=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)
    torch.testing.assert_close(got, full, **FUSED_TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("c", ["at", "above", 200])
def test_fused_mma_path_matches_plain(dev, bits, c):
    """The tensor-core main kernel against the plain version: C at the
    threshold and ragged (not a multiple of the 64-token tile), rows 0,
    64, 65 (a tile edge) and C, heterogeneous expert widths (at 3 bits a
    2-bit expert, whose plane 1 is masked), rank cap full, zero and half,
    gated and not."""
    C = {"at": qm.FUSED_MMA_MIN_C, "above": qm.FUSED_MMA_MIN_C + 2}.get(c, c)
    eb = [bits, max(1, bits - 1), bits, bits]
    for i, cap in enumerate((None, 0, 24)):
        args = _with_rows(_fused_args(dev, 4, C, 256, 260, 48, bits,
                                      gated=i != 1, cap=cap, eb=eb,
                                      seed=bits * C + i), [0, 64, 65, C])
        before = (qm.launches.n, qm.fused_mma_launches.n)
        got = qm._launch_fused("mma", *args, bits=bits, group_size=64)
        assert (qm.launches.n, qm.fused_mma_launches.n) == \
            (before[0] + 1, before[1] + 1)
        want = qm.fused_expert_matmul_plain(*args, bits=bits, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("bits", [2, 3])
def test_fused_threshold_routes_and_matches_plain(dev, bits):
    """Just below FUSED_MMA_MIN_C the wrapper takes the CUDA cores, at it
    the tensor cores; both agree with the plain version."""
    for c in (qm.FUSED_MMA_MIN_C - 1, qm.FUSED_MMA_MIN_C):
        mma = c == qm.FUSED_MMA_MIN_C
        assert qm.fused_path(c) == ("mma" if mma else "simt")
        args = _with_rows(_fused_args(dev, 4, c, 512, 260, 32, bits,
                                      gated=True, cap=20,
                                      eb=[bits, 2, bits, 1], seed=c),
                          [c, c - 3, 70, 0])
        before = qm.fused_mma_launches.n
        got = qm.fused_expert_matmul(*args, bits=bits, group_size=64,
                                     require_kernel=True)
        assert qm.fused_mma_launches.n == before + mma
        want = qm.fused_expert_matmul_plain(*args, bits=bits, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)


def test_fused_mma_path_is_deterministic(dev):
    """The tensor-core path at prefill size returns the same bits on every
    call (no float atomics)."""
    args = _with_rows(_fused_args(dev, 4, 512, 1024, 512, 32, 2, gated=True,
                                  cap=None, eb=[2] * 4, seed=3),
                      [512, 300, 129, 0])
    got = qm._launch_fused("mma", *args, bits=2, group_size=64)
    again = qm._launch_fused("mma", *args, bits=2, group_size=64)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _rank_space_args(dev, C, R, ranks, cap, seed, bits=2, eb=(2, 1, 2, 2)):
    """Decode-sized operands for the rank-space work: E 4, K 256, N 260
    (a ragged last column tile), pad rank R, the given true ranks, every
    slot occupied, each token tile holding compensated rows beside rows
    whose mask is 0 (alternate slots), gated; ``bits`` the container,
    ``eb`` each expert's true width."""
    args = list(_fused_args(dev, 4, C, 256, 260, R, bits, gated=True,
                            cap=cap, eb=list(eb), seed=seed))
    me = torch.zeros((4, C), device=dev)
    me[:, 0::2] = 1.0
    me[1, :] = 1.0                      # one expert with every row
    args[8] = me
    args[12] = torch.tensor(ranks, dtype=torch.int32, device=dev)
    return args


@pytest.mark.parametrize("pad", [1024, 1021])
@pytest.mark.parametrize("cap", ["below", "above"])
@pytest.mark.parametrize("c", [1, 4, 16, 95])
def test_fused_decode_rank_space_matches_plain(dev, c, cap, pad):
    """The decode path's pre-pass and epilogue at decode C (1, the decode
    step's 4, a verify round's 16, the last C below the threshold):
    heterogeneous true ranks up to a 1024 pad (and a pad that is no
    multiple of 4: the pre-pass's byte-load path), a rank cap below and
    above them, rows whose mask is 0 beside compensated ones in one token
    tile, against the plain version."""
    capv = {"below": 300, "above": 2000}[cap]
    args = _rank_space_args(dev, c, pad, [pad, 700, 3, 0], capv, seed=c)
    for a in (args, _with_rows(args, [c, c, max(c - 1, 1), c // 2])):
        got = qm.fused_expert_matmul(*a, bits=2, group_size=64,
                                     require_kernel=True)
        want = qm.fused_expert_matmul_plain(*a, bits=2, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)


def test_fused_simt_path_is_deterministic(dev):
    """The decode path with a rank-1024 expert compensated (the cluster
    pre-pass, the K walk at the tile's occupied slots, the split rank
    walk) returns the same bits on every call, at C 4, 16 and 95 (the top
    of the decode path), and a call captured in a CUDA graph at C 16
    replays to the same bits."""
    for c in (4, 16, 95):
        args = _rank_space_args(dev, c, 1024, [1024, 1024, 517, 0], None,
                                seed=5 + c)
        got = qm._launch_fused("simt", *args, bits=2, group_size=64)
        again = qm._launch_fused("simt", *args, bits=2, group_size=64)
        torch.cuda.synchronize()
        assert torch.equal(got, again), c
    args = _rank_space_args(dev, 16, 1024, [1024, 1024, 517, 0], None,
                            seed=21)
    kw = dict(bits=2, group_size=64, require_kernel=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.fused_expert_matmul(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.fused_expert_matmul(*args, **kw)
    want = qm.fused_expert_matmul(*args, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("bits,eb,c,rows", [
    (2, (2, 1, 2, 2), 16, False), (2, (2, 1, 2, 2), 95, True),
    (3, (3, 2, 3, 1), 16, True), (3, (3, 2, 3, 1), 95, False),
    (8, (8, 4, 2, 8), 16, True), (8, (8, 4, 2, 8), 95, False)])
def test_fused_decode_row_is_routing_independent(dev, bits, eb, c, rows):
    """A token's output row is bit-equal whether it shares the call with
    no other token (C 1), with 3 (C 4, a decode step), with 15 (C 16, a
    verify round) or with 94 (C 95, the top of the decode path): the
    pre-pass's and the decode kernel's sums run in an order fixed by K and
    the rank, not by C or the other tokens.  Also at 3 and 8 bits with
    heterogeneous expert widths, and with occupied-slot counts (slots past
    them empty, in the full call and in each part), so the K walk runs at
    1, 2, 4 and 8 slots for the same token."""
    args = _rank_space_args(dev, c, 1024, [1024, 1024, 517, 0], None,
                            seed=11, bits=bits, eb=eb)
    occ = [c, c - 5, c // 2, 3] if rows else None
    if rows:
        args = list(_with_rows(args, occ))
    full = qm.fused_expert_matmul(*args, bits=bits, group_size=64,
                                  require_kernel=True)
    parts = [(0, 1), (7, 1), (8, 1), (15, 1), (8, 4), (12, 4)]
    if c > 16:
        parts += [(0, 16), (40, 16), (79, 16), (94, 1), (2, 4)]
    for s0, n in parts:
        part = list(args)
        for i in (0, 8, 9):
            part[i] = args[i][:, s0:s0 + n].contiguous()
        if rows:
            part[13] = torch.tensor([min(max(o - s0, 0), n) for o in occ],
                                    dtype=torch.int32, device=dev)
        got = qm.fused_expert_matmul(*part, bits=bits, group_size=64,
                                     require_kernel=True)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:, s0:s0 + n]), (s0, n)


def test_fused_call_replays_in_a_cuda_graph(dev):
    """A decode-sized fused call captured in a CUDA graph, with the mask,
    the true ranks and the rank cap changed in place between replays
    (as the decode graph sees a new plan), equals an eager call on the
    same values."""
    args = _rank_space_args(dev, 4, 1024, [1024, 700, 3, 0], 1024, seed=13)
    kw = dict(bits=2, group_size=64, require_kernel=True)
    me, ranks, cap = args[8], args[12], args[10]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.fused_expert_matmul(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.fused_expert_matmul(*args, **kw)
    for step, (m, r, c) in enumerate((
            ([1, 0, 1, 0], [1024, 700, 3, 0], 1024),
            ([0, 1, 1, 1], [1024, 1024, 64, 5], 200),
            ([0, 0, 0, 0], [1024, 700, 3, 0], 1024),
            ([1, 1, 1, 1], [0, 17, 1024, 1024], 0),
            ([1, 1, 0, 1], [900, 1024, 1024, 1], 1000))):
        me.copy_(torch.tensor(m, dtype=torch.float32, device=dev)
                 .repeat(4, 1))
        ranks.copy_(torch.tensor(r, dtype=torch.int32, device=dev))
        cap.fill_(c)
        graph.replay()
        want = qm.fused_expert_matmul(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want), step
        torch.testing.assert_close(
            out, qm.fused_expert_matmul_plain(*args, bits=2, group_size=64),
            **FUSED_TOL)


def _dispatch_like(dev, E, T, K, top_k, top_n, seed):
    """(E, C=T, K) buffers as ``moe.dispatch_tokens`` fills them: T tokens
    each routed to ``top_k`` distinct random experts, slots taken in token
    order from 0, the first ``top_n`` choices compensated, unnormalised
    gates.  Returns (xe, me, ge, rows, the (T, top_k) choices)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    choice = torch.rand((T, E), generator=g, device=dev).argsort(dim=1)
    choice = choice[:, :top_k]
    e_idx = choice.reshape(-1)
    oh = torch.nn.functional.one_hot(e_idx, E).to(torch.int32)
    slot = (torch.cumsum(oh, dim=0) - oh)[torch.arange(T * top_k,
                                                       device=dev), e_idx]
    xe = torch.zeros((E, T, K), device=dev)
    xe[e_idx, slot] = torch.randn((T * top_k, K), generator=g, device=dev)
    me = torch.zeros((E, T), device=dev)
    me[e_idx, slot] = (torch.arange(top_k, device=dev) < top_n).float() \
        .repeat(T)
    ge = torch.zeros((E, T), device=dev)
    ge[e_idx, slot] = torch.rand((T * top_k,), generator=g, device=dev) * 0.3
    return xe, me, ge, oh.sum(0).to(torch.int32), choice


@pytest.mark.parametrize("path", ["simt", "mma"])
@pytest.mark.parametrize("T", [4, 1000])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_fused_kernel_deepseek_shapes_match_plain(dev, proj, T, path):
    """DeepSeek-MoE-16B's expert grid: E 64, d_model 2048 and d_expert
    1408, top-6 dispatch with top-n 3 at decode (T 4) and a ragged
    prefill (T 1000), pad_rank 1024 on four experts (the kurtosis
    allocation of rank budget 64 gives [1024] * 4 + [0] * 60), each main
    kernel forced at either size, against the plain version in f64."""
    E, R = 64, 1024
    K, N = (2048, 1408) if proj == "w1" else (1408, 2048)
    xe, me, ge, rows, choice = _dispatch_like(dev, E, T, K, 6, 3, seed=T)
    args = list(_fused_args(dev, E, 1, K, N, R, 2, gated=False, cap=None,
                            eb=[2] * E, seed=7 + T))
    ranks = torch.zeros((E,), dtype=torch.int32, device=dev)
    ranks[choice[0, :4]] = R           # token 0's first choices compensated
    args[0], args[8], args[12] = xe, me, ranks
    args[9] = ge if proj == "w2" else None
    args.append(rows)
    got = qm._launch_fused(path, *args, bits=2, group_size=64)
    want = qm.fused_expert_matmul_plain(xe.double(), *args[1:], bits=2,
                                        group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want, **FUSED_TOL)
    live = torch.arange(T, device=dev)[None] < rows[:, None]
    assert not bool(got[~live].any())       # empty slots are exact zeros


@pytest.mark.parametrize("path", ["simt", "mma"])
@pytest.mark.parametrize("T,container", [(4, 8), (512, 4), (512, 8)])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_fused_kernel_qwen3_shapes_match_plain(dev, proj, T, container,
                                               path):
    """Qwen3-MoE-30B-A3B's expert grid: E 128, d_model 2048 and d_expert
    768, top-8 dispatch with top-n 3 at decode (T 4) and at a 512-token
    admission, the heterogeneous widths of an allocated plan in one
    container (2, 3, 4 and 8 bits in an 8-bit one; 2, 3 and 4 in a 4-bit
    one), true ranks 0..256 under pad_rank 256, each main kernel forced
    at either size, against the plain version in f64."""
    E, R = 128, 256
    K, N = (2048, 768) if proj == "w1" else (768, 2048)
    widths = [b for b in (2, 3, 4, 8) if b <= container]
    xe, me, ge, rows, _ = _dispatch_like(dev, E, T, K, 8, 3, seed=T)
    args = list(_fused_args(dev, E, 1, K, N, R, container, gated=False,
                            cap=None, eb=[widths[e % len(widths)]
                                          for e in range(E)], seed=3 + T))
    args[0], args[8] = xe, me
    args[12] = torch.tensor([(0, 16, 0, 32, 128, 0, 256)[e % 7]
                             for e in range(E)], dtype=torch.int32,
                            device=dev)
    args[9] = ge if proj == "w2" else None
    args.append(rows)
    got = qm._launch_fused(path, *args, bits=container, group_size=64)
    want = qm.fused_expert_matmul_plain(xe.double(), *args[1:],
                                        bits=container, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want, **FUSED_TOL)
    live = torch.arange(T, device=dev)[None] < rows[:, None]
    assert not bool(got[~live].any())


def test_artifact_codec_bf16_round_trip_on_card(dev, tmp_path):
    """A stack with bf16 factors saved from the card and loaded back onto
    it: every tensor bit-equal, on the card, in its dtype."""
    from repro_torch.calib.artifact import (load_compression_artifact,
                                            save_compression_artifact)
    from repro_torch.config import ModelConfig, MoEConfig, QuantConfig
    from repro_torch.core.pipeline import compress_expert_stack
    q = QuantConfig(enabled=True, bits=2, rank_budget=16, factor_bits=16,
                    hqq_iters=2)
    cfg = ModelConfig(name="codec", family="moe", num_layers=1, d_model=128,
                      num_heads=2, num_kv_heads=1, d_ff=0, vocab_size=64,
                      moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                                    quant=q))
    g = torch.Generator(device=dev).manual_seed(0)
    stacks = [{p: compress_expert_stack(
        torch.randn(shape, generator=g, device=dev) * 0.05, q,
        bits=np.array([2, 3, 2, 4]))[0]
        for p, shape in (("w1", (4, 128, 64)), ("w2", (4, 64, 128)))}]
    assert stacks[0]["w1"].u.dtype == torch.bfloat16
    save_compression_artifact(tmp_path, cfg, stacks)
    back, _, _ = load_compression_artifact(tmp_path, cfg, device=dev)
    for proj, a in stacks[0].items():
        b = back[0][proj]
        assert (a.bits, a.expert_bits, a.ranks, a.pad_rank) == \
            (b.bits, b.expert_bits, b.ranks, b.pad_rank)
        for x, y in [*zip(a.planes, b.planes)] + [
                (getattr(a, f), getattr(b, f))
                for f in ("scale", "zero", "u", "v", "u_scale", "v_scale")]:
            assert y.device.type == "cuda" and x.dtype == y.dtype
            assert torch.equal(x, y)


def _flash_args(dev, B, H, KVH, hd, S, kind, filled, seed):
    """Flash-decode arguments: slots 0..filled-1 hold positions
    0..filled-1, the rest are empty; ``filled`` "ring": a ring cache that
    wrapped, every slot written, positions out of order."""
    from repro_torch.models.kvcache import _kv_quant
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    if filled == "ring":
        c = S + S // 3
        pos = c - (c - ar) % S
    else:
        filled = min(filled, S)
        c = filled - 1
        pos = torch.where(ar < filled, ar, -1)
    pos = pos[None].repeat(B, 1).contiguous()
    cur = torch.full((B,), c, dtype=torch.int32, device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kind == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    return q, k, v, pos, cur, ks, vs


# (B, H, KVH, hd, S): the first case is the original one; then batch 1;
# B * KVH = 160 rows (cluster size 1); S 1003 (no multiple of a tile or
# of the cluster); S 8192; G 1 and G 8; hd 256 and hd 32 (the reduced
# configs' width); Qwen3-MoE-30B-A3B's G 8 (32 / 4 heads) at serve's
# (4, 512) and (4, 1024) buckets; Qwen2-7B's G 7 (28 / 4 heads, run by
# the G 8 instantiation) and Gemma3-1B's (4 / 1 heads, hd 256) ring;
# RecurrentGemma-9B's G 16 (16 / 1 heads, hd 256: eight query-head groups
# of 2) at its window, and G 9 (four groups of 2 and one of 1);
# Whisper-base's self-attention (G 1, hd 64) at S 128 and 2048
_FLASH_SHAPES = {"whisper_s128": (4, 8, 8, 64, 128),
                 "whisper_s2048": (4, 8, 8, 64, 2048),
                 "rgemma_g16": (4, 16, 1, 256, 2048),
                 "g9": (2, 18, 2, 128, 300),
                 "qwen2_g7": (4, 28, 4, 128, 512),
                 "gemma3_1b": (4, 4, 1, 256, 512),
                 "qwen3_s512": (4, 32, 4, 128, 512),
                 "qwen3_s1024": (4, 32, 4, 128, 1024),
                 "b3g6": (3, 12, 2, 64, 200), "b1": (1, 32, 8, 128, 512),
                 "rows160": (20, 32, 8, 128, 96),
                 "s1003": (2, 16, 4, 128, 1003),
                 "s8192": (2, 32, 8, 128, 8192), "g1": (2, 8, 8, 128, 300),
                 "g8": (2, 64, 8, 128, 300), "hd256": (2, 16, 4, 256, 333),
                 "hd32": (2, 8, 2, 32, 150)}


@pytest.mark.parametrize("shape", list(_FLASH_SHAPES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,filled", [(None, 150), (40, 150),
                                           (None, 3), (None, "ring"),
                                           (70, "ring")])
def test_flash_decode_kernel_matches_plain(dev, kind, window, filled, shape):
    """The kernel against its plain version for each cache type, with and
    without a window, at a prefix of valid slots, at three, and over a
    wrapped ring's unordered positions."""
    B, H, KVH, hd, S = _FLASH_SHAPES[shape]
    seed = filled if isinstance(filled, int) else 11
    args = _flash_args(dev, B, H, KVH, hd, S, kind, filled, seed)
    got = fd.flash_decode_attention(*args, window=window,
                                    require_kernel=True)
    want = fd.flash_decode_attention_plain(*args, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# Gemma3's and RecurrentGemma-9B's (G 16) local layers at decode (B, H,
# KVH, hd, window): a ring of window slots, full and wrapped
_GEMMA3_RINGS = {"gemma3_1b": (4, 4, 1, 256, 512),
                 "gemma3_27b": (4, 32, 16, 128, 1024),
                 "recurrentgemma_9b": (4, 16, 1, 256, 2048)}


@pytest.mark.parametrize("shape", list(_GEMMA3_RINGS))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_window_over_full_ring(dev, kind, shape):
    """A local layer's decode read: a full ring of S = window slots, its
    positions wrapped out of order, ``window == S`` (every slot valid),
    against the plain version; and the same ring one step later, the
    oldest slot rewritten with the new position (the ring's next write),
    so the slot it held falls out of the window."""
    B, H, KVH, hd, S = _GEMMA3_RINGS[shape]
    args = _flash_args(dev, B, H, KVH, hd, S, kind, "ring", 5)
    got = fd.flash_decode_attention(*args, window=S, require_kernel=True)
    want = fd.flash_decode_attention_plain(*args, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    q, k, v, pos, cur, ks, vs = args
    nxt = cur + 1
    pos = pos.clone()
    pos[:, int(nxt[0]) % S] = nxt[0]
    got = fd.flash_decode_attention(q, k, v, pos, nxt, ks, vs, window=S,
                                    require_kernel=True)
    want = fd.flash_decode_attention_plain(q, k, v, pos, nxt, ks, vs, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_flash_decode_kernel_is_deterministic(dev, kind):
    """Two calls on the same inputs give bitwise-equal outputs (the
    cluster merges in a fixed order), at Mixtral's shape, S 4096."""
    args = _flash_args(dev, 4, 32, 8, 128, 4096, kind, 4000, 21)
    got = fd.flash_decode_attention(*args, window=1000, require_kernel=True)
    again = fd.flash_decode_attention(*args, window=1000,
                                      require_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_flash_decode_kernel_replays_in_a_cuda_graph(dev):
    """One launch, no host sync, only the output allocated: the call can be
    captured in a CUDA graph (after a warm-up call) and its replay on new
    cache contents matches an eager call."""
    args = _flash_args(dev, 4, 32, 8, 128, 512, "f32", 288, 31)
    fd.flash_decode_attention(*args, require_kernel=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fd.flash_decode_attention(*args, require_kernel=True)
    args[1].normal_()
    args[2].normal_()
    graph.replay()
    want = fd.flash_decode_attention(*args, require_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_flash_decode_kernel_fully_masked_row_matches_plain(dev, kind):
    """A row with no valid slot gives what the plain version gives there
    (its softmax over equal masked scores: the mean of V, times v_scale
    for int8); the other rows still match the plain version."""
    from repro_torch.models.kvcache import _kv_quant
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, KVH, hd, S = 3, 8, 2, 128, 96
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    ks = vs = None
    if kind == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    pos = torch.where(ar < 40, ar, -1)[None].repeat(B, 1)
    pos[1] = -1
    cur = torch.full((B,), 39, dtype=torch.int32, device=dev)
    got = fd.flash_decode_attention(q, k, v, pos, cur, ks, vs,
                                    require_kernel=True)
    want = fd.flash_decode_attention_plain(q, k, v, pos, cur, ks, vs)
    torch.cuda.synchronize()
    vd = v.float() * (1.0 if vs is None else vs.float()[..., None])
    torch.testing.assert_close(want[1], vd[1].mean(dim=0).repeat_interleave(
        H // KVH, dim=0), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_decode_kernel_gqa_group_3(dev):
    """Llama-3.2-3B's grouping: 24 query heads over 8 KV heads."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, KVH, hd, S = 4, 24, 8, 128, 512
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    pos = torch.where(ar < 288, ar, -1)[None].repeat(B, 1)
    cur = torch.full((B,), 287, dtype=torch.int32, device=dev)
    got = fd.flash_decode_attention(q, k, v, pos, cur, require_kernel=True)
    want = fd.flash_decode_attention_plain(q, k, v, pos, cur)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _paged_flash_args(dev, B, H, KVH, hd, PS, MB, kind, seed):
    """Paged flash-decode arguments (q, k_pool, v_pool, pos_pool, block,
    cur, k_scale, v_scale): pages in random physical order; row 0 maps
    every block (its last page partly filled), row 1 shares row 0's
    leading pages and owns the rest of a shorter span, row 2 maps
    nothing, row 3 maps every other block (-1 between); the trash page
    0 holds finite garbage (rows, scales and positions)."""
    from repro_torch.models.kvcache import _kv_quant
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    own1 = MB - MB // 3
    P = 1 + MB + own1 + (MB + 1) // 2 + 2
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((P, PS, KVH, hd), generator=g, device=dev)
    v = torch.randn((P, PS, KVH, hd), generator=g, device=dev)
    pos = np.full((P, PS), -1, np.int32)
    pos[0] = rng.integers(0, MB * PS, PS)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    block = np.full((B, MB), -1, np.int32)
    block[0] = perm[:MB]
    block[1, :MB // 3] = perm[:MB // 3]
    block[1, MB // 3:MB // 3 + own1 // 2] = perm[MB:MB + own1 // 2]
    if B > 3:
        block[3, ::2] = perm[MB + own1:MB + own1 + (MB + 1) // 2]
    fills = [MB * PS - PS // 2 - 1, (MB // 3 + own1 // 2) * PS - 1, 0,
             MB * PS][:B]
    for r in range(B):
        for j in np.nonzero(block[r] >= 0)[0]:
            lp = j * PS + np.arange(PS)
            pos[block[r, j]] = np.where(lp < fills[r], lp, -1)
    cur = torch.tensor([max(f, 11) - 1 for f in fills], dtype=torch.int32,
                       device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kind == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    return (q, k, v, torch.from_numpy(pos).to(dev),
            torch.from_numpy(block).to(dev), cur, ks, vs)


def _gathered(args):
    """The same call's contiguous arguments: each row's view gathered
    from the pool (``paged_gather``)."""
    from repro_torch.models.kvcache import paged_gather
    q, k, v, pos, block, cur, ks, vs = args
    cache = {"k": k, "v": v, "pos": pos, "block": block}
    if ks is not None:
        cache["k_scale"], cache["v_scale"] = ks, vs
    kf, vf, pf, ksf, vsf = paged_gather(cache)
    return q, kf, vf, pf, cur, ksf, vsf


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("g", [1, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_paged_flash_decode_equals_gather_then_kernel(dev, kind, g, ps):
    """The block-table mode reads the pool in place and equals, bit for
    bit, gathering each row's view and running the contiguous kernel on
    it (same logical S, so the same tiling and cluster); within the
    flash-decode tolerance of the plain route."""
    args = _paged_flash_args(dev, 4, 2 * g, 2, 128, ps, 320 // ps, kind,
                             seed=g * 100 + ps)
    got = fd.flash_decode_attention_paged(*args, require_kernel=True)
    want = fd.flash_decode_attention(*_gathered(args), require_kernel=True)
    plain = fd.flash_decode_attention_paged_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("ps", [1, 8])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_flash_decode_int8_odd_scale_offsets(dev, ps, window):
    """Three kv heads and one-slot pages: a page's scale words start at
    odd bf16 offsets in the pool and at other parities in the gathered
    view, so each mode must pick its own half of each 4-byte word."""
    args = _paged_flash_args(dev, 4, 3, 3, 128, ps, 96 // ps, "int8",
                             seed=7 + ps)
    got = fd.flash_decode_attention_paged(*args, window=window,
                                          require_kernel=True)
    want = fd.flash_decode_attention(*_gathered(args), window=window,
                                     require_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, fd.flash_decode_attention_paged_plain(*args, window=window),
        atol=2e-5, rtol=2e-5)


def test_paged_flash_decode_checks_its_arguments(dev):
    q, k, v, pos, block, cur, _, _ = _paged_flash_args(
        dev, 4, 8, 2, 128, 16, 8, "f32", seed=3)
    n = fd.launches.n
    for bad in (dict(block=block.long()), dict(block=block[:2]),
                dict(pos=pos[:, :8]), dict(k=k[:, :12], v=v[:, :12])):
        kw = dict(q=q, k_pool=k, v_pool=v, pos_pool=pos, block=block,
                  cur_pos=cur)
        kw.update({("k_pool" if n_ == "k" else "v_pool" if n_ == "v"
                    else "pos_pool" if n_ == "pos" else n_): t
                   for n_, t in bad.items()})
        with pytest.raises(ValueError):
            fd.flash_decode_attention_paged(**kw, require_kernel=True)
    assert fd.launches.n == n


def _multi_query(dev, q, cur, nq, seed):
    """Q queries per row for a flash-decode call whose single query is
    ``q`` (B, H, hd) at ``cur`` (B,): fresh (B, nq, H, hd) queries at
    positions cur - nq + 1 .. cur (a verify round's k + 1 positions)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, hd = q.shape
    qm_ = torch.randn((b, nq, h, hd), generator=g, device=dev) / \
        math.sqrt(hd)
    curm = cur[:, None] - nq + 1 + torch.arange(
        nq, dtype=torch.int32, device=dev)[None]
    return qm_, curm.to(torch.int32).contiguous()


# (B, H, KVH, hd, S): Mixtral's G 4 and DeepSeek-MoE's G 1 at serve's
# slot bucket, and Mixtral's at a long cache
_MULTI_SHAPES = {"mixtral": (4, 32, 8, 128, 512),
                 "deepseek": (4, 16, 16, 128, 512),
                 "long": (2, 32, 8, 128, 8192)}


@pytest.mark.parametrize("nq", [2, 4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", list(_MULTI_SHAPES))
def test_flash_decode_multi_query_equals_single_calls(dev, shape, kind, nq):
    """The multi-query mode (the verify pass of speculative decoding):
    each of a row's Q queries at its own position equals, bit for bit, a
    single-query call at that position and the same (B, S) (the same
    cluster size), and the plain version within the flash-decode
    tolerance."""
    B, H, KVH, hd, S = _MULTI_SHAPES[shape]
    q, k, v, pos, cur, ks, vs = _flash_args(dev, B, H, KVH, hd, S, kind,
                                            S - 100, seed=nq)
    qm_, curm = _multi_query(dev, q, cur, nq, seed=nq + 1)
    n = fd.launches.n
    got = fd.flash_decode_attention(qm_, k, v, pos, curm, ks, vs,
                                    require_kernel=True)
    assert fd.launches.n == n + 1
    singles = torch.stack([fd.flash_decode_attention(
        qm_[:, i].contiguous(), k, v, pos, curm[:, i].contiguous(), ks, vs,
        require_kernel=True) for i in range(nq)], dim=1)
    plain = fd.flash_decode_attention_plain(qm_, k, v, pos, curm, ks, vs)
    torch.cuda.synchronize()
    assert got.shape == (B, nq, H, hd)
    assert torch.equal(got, singles)
    torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nq", [2, 4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("g", [1, 4, 16])
def test_paged_flash_decode_multi_query_equals_single_calls(dev, g, kind,
                                                            nq):
    """The multi-query mode over a page pool (page 16): bit-equal to
    single-query block-table calls, and within tolerance of the plain
    route (gather, then the plain version per query)."""
    args = _paged_flash_args(dev, 4, 2 * g, 2, 128, 16, 20, kind,
                             seed=g * 10 + nq)
    q, k, v, pos, block, cur, ks, vs = args
    qm_, curm = _multi_query(dev, q, cur, nq, seed=nq)
    got = fd.flash_decode_attention_paged(qm_, k, v, pos, block, curm, ks,
                                          vs, require_kernel=True)
    singles = torch.stack([fd.flash_decode_attention_paged(
        qm_[:, i].contiguous(), k, v, pos, block, curm[:, i].contiguous(),
        ks, vs, require_kernel=True) for i in range(nq)], dim=1)
    plain = fd.flash_decode_attention_paged_plain(qm_, k, v, pos, block,
                                                  curm, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, singles)
    torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)


def test_flash_decode_multi_query_checks_its_arguments(dev):
    """More than MAX_QUERIES queries, or positions that do not match the
    queries, raise before any launch."""
    q, k, v, pos, cur, _, _ = _flash_args(dev, 2, 8, 2, 128, 64, "f32", 40,
                                          seed=1)
    n = fd.launches.n
    qm_, curm = _multi_query(dev, q, cur, fd.MAX_QUERIES + 1, seed=2)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(qm_, k, v, pos, curm, require_kernel=True)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(qm_[:, :4], k, v, pos, curm[:, :3],
                                  require_kernel=True)
    assert fd.launches.n == n


def _qmm_args(dev, M, K, N, R, bits, seed, mask_mode="half", cap=None,
              group=64):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rint(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dt)

    planes = tuple(rint(0, 256, (K * p // 8, N), torch.uint8)
                   for p, _ in PLANES[bits])
    scale = torch.rand((K // group, N), generator=g, device=dev) * 0.02
    zero = torch.rand((K // group, N), generator=g, device=dev) * 3
    x = torch.randn((M, K), generator=g, device=dev)
    if R == 0:
        return (x, planes, scale, zero)
    u = rint(-127, 128, (K, R), torch.int8)
    v = rint(-127, 128, (R, N), torch.int8)
    us = torch.rand((1, R), generator=g, device=dev) * 1e-3
    vs = torch.rand((R, 1), generator=g, device=dev) * 1e-3
    mask = {"none": None, "ones": torch.ones((M,), device=dev),
            "half": (torch.rand((M,), generator=g, device=dev) < 0.5)
            .float(), "zeros": torch.zeros((M,), device=dev)}[mask_mode]
    capt = None if cap is None else torch.tensor([cap], dtype=torch.int32,
                                                 device=dev)
    return (x, planes, scale, zero, u, us, v, vs, mask, capt)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 33, 64, 65, 130, 200, 1024])
def test_quant_matmul_kernel_matches_plain(dev, bits, m):
    """Kernel 3 (csrc/quant_matmul.cu) against its plain version: the
    compensated form with a ragged M, a mask with zeros and a rank cap
    below R, and the uncompensated form.  At prefill sizes (M >= 64: the
    split-K path below MMA_MIN_M, the tensor-core path from it) also rank
    caps 20 and 0 and a mask of zeros."""
    cases = [dict(R=48, mask_mode="half", cap=[None, 17, 0][bits % 3]),
             dict(R=0)]
    if m >= 64:
        cases += [dict(R=48, mask_mode="half", cap=20),
                  dict(R=48, mask_mode="zeros", cap=0)]
    for i, c in enumerate(cases):
        args = _qmm_args(dev, m, 512, 260, c.pop("R"), bits, bits * m + i,
                         **c)
        before = qm.qmm_launches.n
        got = qm.quant_matmul(*args, bits=bits, group_size=64,
                              require_kernel=True)
        assert qm.qmm_launches.n == before + 1
        want = qm.quant_matmul_plain(*args, bits=bits, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("m,k,n", [(4, 3072, 1024), (4, 8192, 512),
                                   (130, 1024, 1024)])
@pytest.mark.parametrize("mask_mode", ["none", "zeros"])
def test_quant_matmul_kernel_split_k(dev, m, k, n, mask_mode):
    """Decode-like shapes that split K over blocks (and one that does
    not), with every token or no token compensated; the result is the
    same from run to run (the splits are summed in a fixed order)."""
    args = _qmm_args(dev, m, k, n, 32, 2, k + n, mask_mode=mask_mode)
    got = qm.quant_matmul(*args, bits=2, group_size=64, require_kernel=True)
    again = qm.quant_matmul(*args, bits=2, group_size=64,
                            require_kernel=True)
    want = qm.quant_matmul_plain(*args, bits=2, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)
    assert torch.equal(got, again)


def test_quant_matmul_mma_path_is_deterministic(dev):
    """The tensor-core path at prefill size returns the same bits on every
    call (no float atomics)."""
    args = _qmm_args(dev, 1024, 1024, 1024, 32, 2, 3, mask_mode="half")
    got = qm.quant_matmul(*args, bits=2, group_size=64, require_kernel=True)
    again = qm.quant_matmul(*args, bits=2, group_size=64,
                            require_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("bits", [2, 3])
def test_quant_matmul_threshold_matches_plain(dev, bits):
    """Just below MMA_MIN_M (split-K) and at it (tensor cores): both agree
    with the plain version on the same weights."""
    for m in (qm.MMA_MIN_M - 1, qm.MMA_MIN_M):
        assert qm.qmm_path(m) == ("mma" if m == qm.MMA_MIN_M else "splitk")
        args = _qmm_args(dev, m, 2048, 520, 32, bits, 7, cap=20)
        got = qm.quant_matmul(*args, bits=bits, group_size=64,
                              require_kernel=True)
        want = qm.quant_matmul_plain(*args, bits=bits, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("path", ["splitk", "mma"])
@pytest.mark.parametrize("m", [16, 130])
def test_quant_matmul_either_path_at_any_m(dev, path, m):
    """Each path run at a token count where the wrapper would take the
    other one (the crossover timing does this) still matches the plain
    version."""
    args = _qmm_args(dev, m, 1024, 1024, 32, 2, m, cap=20)
    got = qm._launch_qmm(path, *args, bits=2, group_size=64)
    want = qm.quant_matmul_plain(*args, bits=2, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("m", [4, 200])
@pytest.mark.parametrize("group", [128, 512])
def test_quant_matmul_kernel_wide_groups(dev, m, group):
    """Groups of several pack blocks share one scale/zero row, on both
    paths."""
    args = _qmm_args(dev, m, 1024, 264, 32, 3, group + m, cap=20,
                     group=group)
    got = qm.quant_matmul(*args, bits=3, group_size=group,
                          require_kernel=True)
    want = qm.quant_matmul_plain(*args, bits=3, group_size=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


# Llama-3.2-3B's dense FFN projections (K, N): w1 / w3 and w2
_LLAMA = {"w1": (3072, 8192), "w2": (8192, 3072)}
# Gemma3-1B's
_GEMMA3_1B = {"w1": (1152, 6912), "w2": (6912, 1152)}


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 16, 33, 127])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_quant_matmul_decode_llama_shapes(dev, proj, m):
    """The decode kernel (one launch, K split over a cluster) at
    Llama-3.2-3B's projections, every token compensated, at every token
    tile width and ragged M below MMA_MIN_M."""
    _decode_shape_case(dev, *_LLAMA[proj], m)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_quant_matmul_decode_gemma3_shapes(dev, proj, m):
    """The decode kernel at Gemma3-1B's projections (K 1152 = 18 pack
    blocks, K 6912 = 108), as the decode step runs them."""
    _decode_shape_case(dev, *_GEMMA3_1B[proj], m)


# RecurrentGemma-9B's (w1/w3, then w2): K 4096 -> N 12288 and back
_RECURRENTGEMMA = {"w1": (4096, 12288), "w2": (12288, 4096)}


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_quant_matmul_decode_recurrentgemma_shapes(dev, proj, m):
    """The decode kernel at RecurrentGemma-9B's projections (K 4096 = 64
    pack blocks, K 12288 = 192), as its decode step runs them."""
    _decode_shape_case(dev, *_RECURRENTGEMMA[proj], m)


# Whisper-base's decoder FFN (plain MLP, 3-bit E = 1 stacks of rank 16):
# K 512 -> N 2048 and back
_WHISPER = {"w1": (512, 2048), "w2": (2048, 512)}


@pytest.mark.parametrize("m", [1, 4, 256])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_quant_matmul_whisper_3bit_shapes(dev, proj, m):
    """Kernel 3 at 3 bits (a 2-bit and a 1-bit plane) on Whisper's
    projections: the decode kernel at M 1 and 4, the tensor-core tile at
    M 256 (a prefill of 64-token prompts at batch 4)."""
    k, n = _WHISPER[proj]
    args = _qmm_args(dev, m, k, n, 16, 3, m + k, mask_mode="ones")
    got = qm.quant_matmul(*args, bits=3, group_size=64, require_kernel=True)
    want = qm.quant_matmul_plain(*args, bits=3, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


def _decode_shape_case(dev, k, n, m):
    assert qm.qmm_path(m) == "splitk"
    args = _qmm_args(dev, m, k, n, 32, 2, m + k, mask_mode="ones")
    before = qm.qmm_launches.n
    got = qm.quant_matmul(*args, bits=2, group_size=64, require_kernel=True)
    assert qm.qmm_launches.n == before + 1
    want = qm.quant_matmul_plain(*args, bits=2, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mask_mode,cap,r",
                         [("ones", None, 32), ("half", 17, 32),
                          ("zeros", None, 32), ("half", 0, 32),
                          ("none", 40, 32), ("half", None, 0)])
def test_quant_matmul_decode_bits_masks_caps(dev, bits, mask_mode, cap, r):
    """The decode kernel at Llama's w1 at M 4 (a decode step of batch 4)
    for every width: masks of ones, half and zeros, rank caps below R, 0
    and above R, and no compensation (r 0)."""
    k, n = _LLAMA["w1"]
    args = _qmm_args(dev, 4, k, n, r, bits, bits * 7 + (cap or 0),
                     mask_mode=mask_mode, cap=cap)
    got = qm.quant_matmul(*args, bits=bits, group_size=64,
                          require_kernel=True)
    want = qm.quant_matmul_plain(*args, bits=bits, group_size=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("m", [1, 3, 4, 16])
@pytest.mark.parametrize("group", [64, 128])
def test_quant_matmul_decode_uneven_k(dev, m, group):
    """K 1408 (22 pack blocks, DeepSeek-MoE's expert width) split over a
    cluster whose blocks do not all walk the same number of pack blocks,
    in groups of one and of two pack blocks."""
    k, n = 1408, 2048
    cs, kch = qm.decode_splits(dev, m, k, n, 32, 3)
    assert cs > 1 and (k // 64) % kch != 0
    args = _qmm_args(dev, m, k, n, 32, 3, m + group, mask_mode="half",
                     cap=20, group=group)
    got = qm.quant_matmul(*args, bits=3, group_size=group,
                          require_kernel=True)
    want = qm.quant_matmul_plain(*args, bits=3, group_size=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_quant_matmul_decode_is_deterministic(dev, proj):
    """The decode kernel returns the same bits on every call: the cluster
    sums its blocks' partials and rank-space shares in a fixed order (no
    atomics)."""
    k, n = _LLAMA[proj]
    for m in (1, 4, 16):
        args = _qmm_args(dev, m, k, n, 32, 2, m, mask_mode="half")
        outs = [qm.quant_matmul(*args, bits=2, group_size=64,
                                require_kernel=True) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("r", [32, 0])
def test_quant_matmul_decode_is_one_launch(dev, r):
    """A compensated (r 32) or uncompensated (r 0) call at M 4 is one
    kernel on the card, the decode kernel: over 5 calls the profiler sees
    no other kernel and at most 5 launches (it may miss one now and
    then), and the wrapper counts one launch per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    k, n = _LLAMA["w1"]
    args = _qmm_args(dev, 4, k, n, r, 2, 5, mask_mode="ones")
    qm.quant_matmul(*args, bits=2, group_size=64, require_kernel=True)
    torch.cuda.synchronize()
    before = qm.qmm_launches.n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            qm.quant_matmul(*args, bits=2, group_size=64,
                            require_kernel=True)
        torch.cuda.synchronize()
    assert qm.qmm_launches.n == before + 5
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    assert 1 <= len(names) <= 5, names
    assert all("qmm_decode_kernel" in nm for nm in names), names


def test_quant_matmul_decode_geometry_on_card(dev):
    """On this card the wrapper's decode geometry for Llama's projections
    at M 1..8: one wave of at most one block per SM (the clusters fit at
    the occupancy the card reports), at least two pack blocks per warp,
    every split non-empty and K covered exactly."""
    for k, n in _LLAMA.values():
        for m in range(1, 9):
            cs, kch = qm.decode_splits(dev, m, k, n, 32, 2)
            n_pb = k // 64
            assert (cs - 1) * kch < n_pb <= cs * kch
            assert n_pb - (cs - 1) * kch >= 2 * qm.QMM_WARPS
            tiles = -(-m // qm.token_tile(m)) * -(-n // qm.QMM_BN)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            assert tiles * cs <= sms
            assert cs == 1 or tiles <= qm.decode_occupancy(
                dev, 2, m, 32, cs)[0]


def test_dense_engine_kernels_match_ref_on_card(dev):
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    import dataclasses
    cfg = get_config("llama3.2-3b", reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    qp, cfg_q = compress_dense_params(
        params, cfg, dataclasses.replace(cfg.quant, rank_budget=16))
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    before = (qm.qmm_launches.n, fd.launches.n)
    a = ServeEngine(cfg_q, qp, quantized=True).generate(prompts, 6)
    assert qm.qmm_launches.n > before[0] and fd.launches.n > before[1]
    b = ServeEngine(cfg_q, qp, quantized=True,
                    kernel_impl="ref").generate(prompts, 6)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-4, atol=1e-4)
    assert a.router_trace is None


def test_engine_kernels_match_ref_on_card(dev):
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("mixtral-8x7b", reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    qp, cfg_q, _ = compress_moe_params(params, cfg)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    before = (qm.launches.n, fd.launches.n)
    a = ServeEngine(cfg_q, qp, quantized=True).generate(prompts, 6)
    assert qm.launches.n > before[0] and fd.launches.n > before[1]
    b = ServeEngine(cfg_q, qp, quantized=True,
                    kernel_impl="ref").generate(prompts, 6)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-4, atol=1e-4)


_ENGINES = {}


def _served(kind):
    """A compressed reduced model on the card: 'moe' (Mixtral-8x7B) or
    'dense' (Llama-3.2-3B, E = 1 stacks), with prompts of its vocab."""
    import dataclasses
    from repro_torch.models.transformer import (compress_dense_params,
                                                compress_moe_params,
                                                init_params)
    from repro_torch.registry import get_config
    if kind not in _ENGINES:
        if kind == "moe":
            cfg = get_config("mixtral-8x7b", reduced=True)
            params = init_params(cfg, seed=0, dtype=torch.float32)
            qp, cfg_q, _ = compress_moe_params(params, cfg)
        else:
            cfg = get_config("llama3.2-3b", reduced=True)
            params = init_params(cfg, seed=0, dtype=torch.float32)
            qp, cfg_q = compress_dense_params(
                params, cfg, dataclasses.replace(cfg.quant, rank_budget=16))
        _ENGINES[kind] = (cfg_q, qp)
    return _ENGINES[kind]


def _prompts(cfg, b, n, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, n)).astype(np.int32)


def _assert_same_generation(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    if a.router_trace is None:
        assert b.router_trace is None
    else:
        np.testing.assert_array_equal(a.router_trace, b.router_trace)
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_graph_generate_matches_eager(dev, kind):
    """Replaying the captured decode step gives the eager loop's tokens
    and router trace, and its log-probs within 1e-5."""
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served(kind)
    prompts = _prompts(cfg, 3, 9)
    graph = ServeEngine(cfg, qp, quantized=True)
    eager = ServeEngine(cfg, qp, quantized=True, decode_graph=False)
    assert graph.decode_graph and not eager.decode_graph
    a = graph.generate(prompts, 7)
    b = eager.generate(prompts, 7)
    assert graph.num_graphs == 1 and a.capture_s > 0
    assert eager.num_graphs == 0 and b.capture_s == 0
    assert (a.router_trace is None) == (kind == "dense")
    _assert_same_generation(a, b)


def test_window_engine_graph_matches_eager(dev):
    """Reduced Gemma3-1B (5 local layers with rings of 16 and a global
    one, E = 1 stacks): ``generate`` with 21-token prompts (the rings wrap
    at prefill) through the decode graph gives the eager loop's tokens and
    log-probs within 1e-5, flash-decode runs with a window on every local
    layer of every eager step, and a second bucket (cache 128 against 64,
    the same rings) captures its own graph.  ``serve`` on prompts of 11
    and 27 tokens (both sides of the window) gives the eager serve's
    tokens."""
    import dataclasses
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request
    cfg = get_config("gemma3-1b", reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    qp, cfg_q = compress_dense_params(
        params, cfg, dataclasses.replace(cfg.quant, rank_budget=16))
    graph = ServeEngine(cfg_q, qp, quantized=True)
    eager = ServeEngine(cfg_q, qp, quantized=True, decode_graph=False)
    prompts = _prompts(cfg, 3, 21)
    a = graph.generate(prompts, 20)
    before = fd.window_launches.n
    b = eager.generate(prompts, 20)
    # 5 local layers, in the prefill (none: plain attention) and 20 steps
    assert fd.window_launches.n - before == 5 * 20
    _assert_same_generation(a, b)
    assert graph.num_graphs == 1
    long = _prompts(cfg, 3, 50, seed=1)
    _assert_same_generation(graph.generate(long, 20),
                            eager.generate(long, 20))
    assert graph.num_graphs == 2
    rng = np.random.default_rng(2)
    reqs = [rng.integers(2, cfg.vocab_size, (n,)).astype(np.int32)
            for n in (11, 27, 27, 11, 27, 11)]

    def serve(eng):
        return eng.serve([Request(uid=i, tokens=t, max_new=10)
                          for i, t in enumerate(reqs)], num_slots=2,
                         chunk=4, seed=0)
    for x, y in zip(serve(graph).results, serve(eager).results):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        np.testing.assert_allclose(x.logprobs, y.logprobs, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_stateful_engine_graph_matches_eager(dev, arch):
    """Reduced RecurrentGemma-9B (2 recurrent layers and a local ring of
    16, E = 1 stacks) and xLSTM-125M (an mLSTM and an sLSTM block):
    ``generate`` with 21-token prompts through the decode graph gives the
    eager loop's tokens and log-probs within 1e-5 (every state leaf is
    written in place, so the replay reads and writes the graph's own
    buffers); RecurrentGemma's eager loop runs flash-decode with a window
    once per step (its one local layer).  A second bucket past the window
    (cache 128 against 64) has resident caches of its own and captures
    its own graph; ``serve`` (prompts of 11 and 27 tokens, contiguous and
    at page 8) gives the eager serve's tokens."""
    import dataclasses
    from repro_torch.models.transformer import (compress_dense_params,
                                                init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    quantized = arch == "recurrentgemma-9b"
    if quantized:
        params, cfg = compress_dense_params(
            params, cfg, dataclasses.replace(cfg.quant, rank_budget=16))
    graph = ServeEngine(cfg, params, quantized=quantized)
    eager = ServeEngine(cfg, params, quantized=quantized, decode_graph=False)
    prompts = _prompts(cfg, 3, 21)
    a = graph.generate(prompts, 20)
    before = fd.window_launches.n
    b = eager.generate(prompts, 20)
    assert fd.window_launches.n - before == (20 if quantized else 0)
    assert a.logprobs.shape == (3, 20) and np.isfinite(a.logprobs).all()
    _assert_same_generation(a, b)
    assert graph.num_graphs == 1
    long = _prompts(cfg, 3, 50, seed=1)
    _assert_same_generation(graph.generate(long, 20),
                            eager.generate(long, 20))
    assert graph.num_graphs == 2
    rng = np.random.default_rng(2)
    reqs = [rng.integers(2, cfg.vocab_size, (n,)).astype(np.int32)
            for n in (11, 27, 27, 11, 27, 11)]

    def serve(eng, **kw):
        return eng.serve([Request(uid=i, tokens=t, max_new=10)
                          for i, t in enumerate(reqs)], num_slots=2,
                         chunk=4, seed=0, **kw)
    for kw in ({}, {"page_size": 8}):
        for x, y in zip(serve(graph, **kw).results,
                        serve(eager, **kw).results):
            np.testing.assert_array_equal(x.tokens, y.tokens)
            np.testing.assert_allclose(x.logprobs, y.logprobs, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_one_graph_per_bucket(dev, kind):
    """Three generates in one (batch, cache) bucket, prompt lengths 5, 7
    and 9 (all pad to 16; 16 + 4 + 1 -> cache 32), share one capture,
    the counterpart of the JAX engine's one compile per bucket; another
    bucket captures once more."""
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served(kind)
    eng = ServeEngine(cfg, qp, quantized=True)
    eager = ServeEngine(cfg, qp, quantized=True, decode_graph=False)
    for n in (5, 7, 9):
        prompts = _prompts(cfg, 2, n, seed=n)
        res = eng.generate(prompts, 4)
        assert (res.capture_s > 0) == (n == 5)
        _assert_same_generation(res, eager.generate(prompts, 4))
    assert eng.num_graphs == 1
    eng.generate(_prompts(cfg, 2, 20), 4)      # pads to 32 -> cache 64
    assert eng.num_graphs == 2


def test_plan_change_replays_without_capture(dev):
    """A new (moe_layers, 2) [top_n, rank_cap] plan between generates is
    a copy into the graph's plan buffer: no new capture, and the replay
    equals the eager decode steps with the new plan."""
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served("moe")
    prompts = _prompts(cfg, 2, 9)
    n_moe = sum("moe" in lp for lp in qp["layers"])
    pad = next(lp["moe"]["stacks"]["w1"].pad_rank for lp in qp["layers"]
               if "moe" in lp)
    plans = ([[1, pad]] * n_moe, [[2, pad // 2]] * n_moe,
             [[0, 0]] * n_moe)
    eng = ServeEngine(cfg, qp, quantized=True)
    eager = ServeEngine(cfg, qp, quantized=True, decode_graph=False)
    seen = []
    for plan in plans:
        res = eng.generate(prompts, 6, plan=plan)
        _assert_same_generation(res, eager.generate(prompts, 6, plan=plan))
        seen.append(res.logprobs)
    assert eng.num_graphs == 1
    assert not np.array_equal(seen[0], seen[2])


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_decode_step_has_no_host_sync(dev, kind):
    """The warm-up step before a capture raises nothing under
    ``torch.cuda.set_sync_debug_mode('error')``: the step neither copies
    from the host nor waits for the card."""
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served(kind)
    eng = ServeEngine(cfg, qp, quantized=True)
    logits, caches = eng.prefill(_prompts(cfg, 2, 9), 4)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = eng.step(tok, caches)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out.logits).all()


def test_failed_capture_raises_without_eager_fallback(dev, monkeypatch):
    """A decode step that waits on the card fails its warm-up under the
    sync check: ``generate`` raises, no graph is kept, and the engine
    stays a graph engine (the next call tries to capture again)."""
    from repro_torch.models import model as lm
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served("dense")
    eng = ServeEngine(cfg, qp, quantized=True)
    real = lm.decode_step

    def syncing_step(*args, **kwargs):
        args[1].sum().item()            # tokens: a host read
        return real(*args, **kwargs)

    monkeypatch.setattr(lm, "decode_step", syncing_step)
    with pytest.raises(RuntimeError):
        eng.generate(_prompts(cfg, 2, 9), 4)
    assert eng.num_graphs == 0 and eng.decode_graph
    assert torch.cuda.get_sync_debug_mode() == 0


def test_slot_claim_and_reset_in_place_on_card(dev):
    """A batch-1 request cache claimed into slot 2 of four on the card:
    that row equals the request's, the others stay empty, the tensors a
    decode graph reads are the same ones; a reset empties the row."""
    from repro_torch.models.transformer import (cache_claim_slot,
                                                cache_reset_slot,
                                                init_caches)
    cfg, _ = _served("moe")
    caches = init_caches(cfg, 4, 64, torch.float32, device=dev)
    req = init_caches(cfg, 1, 64, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for c in req["layers"]:
        for key, t in c.items():
            t.copy_(torch.randint(0, 50, t.shape, generator=g, device=dev))
    req["pos"].fill_(37)
    ptrs = [t.data_ptr() for c in caches["layers"] for t in c.values()]
    assert cache_claim_slot(cfg, caches, req, 2) is caches
    for c, r in zip(caches["layers"], req["layers"]):
        for key in c:
            assert torch.equal(c[key][2], r[key][0]), key
            assert (c[key][[0, 1, 3]] == (-1 if key == "pos" else 0)).all()
    assert caches["pos"].tolist() == [0, 0, 37, 0]
    cache_reset_slot(cfg, caches, 2)
    for c in caches["layers"]:
        assert (c["pos"] == -1).all() and not c["k"].any()
    assert caches["pos"].tolist() == [0, 0, 0, 0]
    assert ptrs == [t.data_ptr() for c in caches["layers"]
                    for t in c.values()]


def test_serve_graph_matches_eager_on_ragged_workload(dev):
    """``serve`` on a ragged workload (slots at different depths, dead
    slots stepping on) with offload metering, once with the static plan
    and once under a budget: the decode graph gives the eager loop's
    tokens, traces, offload reports and plan traces, and captures one
    graph per (slots, bucket, plan or none) however often the plan
    changes."""
    from repro_torch.config import ControlConfig
    from repro_torch.serve import ServeEngine, synthetic_workload
    cfg, qp = _served("moe")
    stacks = [lp["moe"]["stacks"] for lp in qp["layers"] if "moe" in lp]

    def workload():
        return synthetic_workload(9, cfg.vocab_size, max_new=10, min_len=5,
                                  max_len=70, seed=3)

    runs = {}
    for graph in (True, False):
        eng = ServeEngine(cfg, qp, quantized=True, decode_graph=graph)
        eng.attach_offload(stacks, cache_capacity=3)
        static = eng.serve(workload(), num_slots=4, chunk=4)
        eng.attach_offload(stacks, cache_capacity=3)
        eng.attach_controller(ControlConfig(
            enabled=True,
            bytes_per_token=0.7 * static.offload_report["bytes_per_token"]))
        budget = eng.serve(workload(), num_slots=4, chunk=4)
        runs[graph] = (static, budget, eng.num_graphs)
    assert runs[True][2] == 2 and runs[False][2] == 0
    for a, b in zip(runs[True][:2], runs[False][:2]):
        for ra, rb in zip(a.results, b.results):
            np.testing.assert_array_equal(ra.tokens, rb.tokens)
            np.testing.assert_array_equal(ra.trace, rb.trace)
            assert ra.offload_bytes == rb.offload_bytes
        np.testing.assert_array_equal(a.router_trace, b.router_trace)
        assert a.offload_report == b.offload_report
    np.testing.assert_array_equal(runs[True][1].plan_trace,
                                  runs[False][1].plan_trace)
    assert len({p.tobytes() for p in runs[True][1].plan_trace}) > 1


def _ragged(cfg, mix, seed):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(2, cfg.vocab_size, (p,),
                                               dtype=np.int32),
                    max_new=n) for i, (p, n) in enumerate(mix)]


def test_paged_serve_one_graph_per_envelope(dev):
    """``serve(page_size=8)`` on a ragged workload captures one decode
    graph for its paged envelope (slots, pages, page size, blocks) and a
    second ragged workload in the same envelope captures none; each
    equals the eager loop's paged serve (tokens, traces, offload
    reports, page reports), and no page leaks."""
    from repro_torch.serve import ServeEngine
    cfg, qp = _served("moe")
    stacks = [lp["moe"]["stacks"] for lp in qp["layers"] if "moe" in lp]
    mixes = (((5, 7), (19, 4), (33, 9), (9, 3), (12, 6), (24, 5)),
             ((33, 9), (19, 4), (24, 5), (7, 5)))
    runs = {}
    for graph in (True, False):
        eng = ServeEngine(cfg, qp, quantized=True, decode_graph=graph)
        out = []
        for i, mix in enumerate(mixes):
            eng.attach_offload(stacks, cache_capacity=3)
            out.append(eng.serve(_ragged(cfg, mix, i), num_slots=3,
                                 chunk=4, page_size=8))
            eng._page_pool.check_leaks()
            if graph:
                assert eng.num_graphs == 1, i
        runs[graph] = out
    for a, b in zip(runs[True], runs[False]):
        for ra, rb in zip(a.results, b.results):
            np.testing.assert_array_equal(ra.tokens, rb.tokens)
            np.testing.assert_array_equal(ra.trace, rb.trace)
            np.testing.assert_allclose(ra.logprobs, rb.logprobs, rtol=1e-5,
                                       atol=1e-5)
        assert a.offload_report == b.offload_report
        assert a.page_report == b.page_report
    assert runs[True][0].cache_hbm_bytes == runs[True][1].cache_hbm_bytes


def test_paged_decode_launches_the_block_table_kernel(dev):
    """A paged decode step on the card launches flash-decode once per
    layer in its block-table mode and gathers nothing: ``paged_gather``
    is never called."""
    from repro_torch.models import attention
    from repro_torch.serve import ServeEngine
    cfg, qp = _served("moe")
    eng = ServeEngine(cfg, qp, quantized=True, decode_graph=False)
    called = []
    real = attention.paged_gather
    attention.paged_gather = lambda *a: called.append(1) or real(*a)
    try:
        n = fd.launches.n
        st = eng.serve(_ragged(cfg, ((9, 3), (20, 4)), 5), num_slots=2,
                       chunk=4, page_size=16)
    finally:
        attention.paged_gather = real
    assert not called
    layers = len(qp["layers"])
    assert fd.launches.n - n == layers * st.chunks * 4


# ---------------------------------------------------------------------------
# async expert streaming on the card
# ---------------------------------------------------------------------------

def _own_moe_params(qp):
    """``qp`` with its own layer and MoE dicts (the same stacks):
    ``attach_streaming`` replaces the MoE dicts' stacks with its
    containers, which must not reach the shared ``_served`` params."""
    return {**qp, "layers": [dict(lp, moe=dict(lp["moe"])) if "moe" in lp
                             else lp for lp in qp["layers"]]}


def _streamed(policy="block", cap=8):
    from repro_torch.config import StreamConfig
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served("moe")
    own = _own_moe_params(qp)
    stacks = [lp["moe"]["stacks"] for lp in own["layers"] if "moe" in lp]
    eng = ServeEngine(cfg, own, quantized=True)
    eng.attach_offload(stacks, cache_capacity=cap)
    eng.attach_streaming(StreamConfig(enabled=True, miss_policy=policy))
    return eng, stacks


def test_stream_host_image_is_pinned(dev):
    """Every layer's host image (and so every payload) is pinned memory;
    the containers are the engine's MoE stacks, on the card."""
    eng, stacks = _streamed()
    for li, L in enumerate(eng.stream.layers):
        assert L.image.buffer.is_pinned()
        assert L.image.weight_payload(0).data.is_pinned()
        assert L.image.host_nbytes > 0
        assert all(st.scale.is_cuda for st in L.containers.values())
        assert L.containers is not stacks[li]


def test_stream_ring_copies_run_on_a_copy_stream(dev):
    """A ring copy is issued on the backend's own (non-default) stream
    and its slot turns READY exactly when the copy's event has fired:
    held back behind a spin on the copy stream, it stays IN_FLIGHT."""
    eng, _ = _streamed()
    backend = eng.stream.backend
    assert backend.stream.cuda_stream != \
        torch.cuda.default_stream(dev).cuda_stream
    L = eng.stream.layers[0]
    with torch.cuda.stream(backend.stream):
        torch.cuda._sleep(200_000_000)          # ~0.1 s at 2 GHz
    slot = L.ring.try_issue(3, L.image.weight_payload(3), 1)
    L.ring.poll()
    assert slot.state == "in_flight" and not slot.handle.event.query()
    backend.stream.synchronize()
    L.ring.poll()
    assert slot.state == "ready" and slot.handle.event.query()
    eng.stream.integrate_ready(0)
    assert slot.state == "free" and 3 in L.valid
    torch.cuda.synchronize()
    for name, st in L.containers.items():
        assert torch.equal(st.scale[3], eng._stores[0].stacks[name].scale[3])


def test_stream_graph_reads_containers_in_place(dev):
    """Payloads integrated between two replays of one captured decode
    step (ring copies through ``integrate_ready``, then demand copies)
    change what the replay computes, with no new capture; once every
    expert's weights and factors are in, the replay equals the resident
    engine's eager step on the true stacks."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.offload.staging import _NO_FACTORS
    eng, stacks = _streamed()
    cfg, qp = _served("moe")
    ref = ServeEngine(cfg, qp, quantized=True, decode_graph=False)
    prompts = _prompts(cfg, 2, 9)
    logits, caches = eng.prefill(prompts, 4)
    eng.decode(logits, caches, 1)                # captures the step
    assert eng.num_graphs == 1
    g = next(iter(eng.graphs.values()))
    r_logits, r_caches = ref.prefill(prompts, 4)
    tok = torch.argmax(r_logits, dim=-1).to(torch.int32)
    want = ref.step(tok, {"layers": [{k: t.clone() for k, t in c.items()}
                                     for c in r_caches["layers"]],
                          "pos": r_caches["pos"].clone()}).logits

    def replay():
        for c, r in zip(caches["layers"], r_caches["layers"]):
            for k in c:
                c[k].copy_(r[k])
        caches["pos"].copy_(r_caches["pos"])
        g.tokens.copy_(tok)
        g.graph.replay()
        return g.logits.clone()

    before = replay()
    se = eng.stream
    n_moe = len(stacks)
    se.stage_async([(l, e, True, _NO_FACTORS) for l in range(n_moe)
                    for e in range(2)])
    se.backend.stream.synchronize()
    se.integrate_ready()
    assert all({0, 1} <= L.valid for L in se.layers)
    ring = replay()
    assert not torch.equal(ring, before)
    assert not se.demand_stage([(l, e, True, None) for l in range(n_moe)
                                for e in range(8)])
    full = replay()
    assert eng.num_graphs == 1
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)


def test_graph_captured_before_streaming_is_dropped(dev):
    """A decode graph captured over the true stacks is never replayed
    after ``attach_streaming``: the engine drops it, captures once over
    the containers, and block-mode tokens equal the resident ones."""
    from repro_torch.config import StreamConfig
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served("moe")
    own = _own_moe_params(qp)
    stacks = [lp["moe"]["stacks"] for lp in own["layers"] if "moe" in lp]
    eng = ServeEngine(cfg, own, quantized=True)
    prompts = _prompts(cfg, 2, 9)
    a = eng.generate(prompts, 6)
    old = list(eng.graphs.values())
    assert len(old) == 1
    eng.attach_offload(stacks, cache_capacity=8)
    eng.attach_streaming(StreamConfig(enabled=True))
    assert eng.num_graphs == 0
    b = eng.generate(prompts, 6)
    assert eng.num_graphs == 1
    assert not any(g is old[0] for g in eng.graphs.values())
    assert b.stream_report["reruns"] > 0
    _assert_same_generation(a, b)


@pytest.mark.parametrize("cap", [8, 3])
def test_streamed_block_serve_equals_resident_on_card(dev, cap):
    """``serve`` of a ragged workload streamed under 'block' (LRU ``cap``
    of 8, through the plan graph) gives the resident engine's tokens and
    traces; every store's metered bytes equal its copies' bytes; then a
    serve under a budget changes the plan between chunks: one graph is
    captured across every integration and plan change."""
    from repro_torch.config import ControlConfig
    from repro_torch.serve import ServeEngine, synthetic_workload
    cfg, qp = _served("moe")
    stacks = [lp["moe"]["stacks"] for lp in qp["layers"] if "moe" in lp]

    def workload():
        return synthetic_workload(7, cfg.vocab_size, max_new=8, min_len=5,
                                  max_len=60, seed=4)

    # no budget: the plan stays at the static point on both engines
    res = ServeEngine(cfg, qp, quantized=True)
    res.attach_offload(stacks, cache_capacity=cap)
    res.attach_controller(ControlConfig(enabled=True))
    want = res.serve(workload(), num_slots=4, chunk=4)
    eng, _ = _streamed(cap=cap)
    eng.attach_controller(ControlConfig(enabled=True))
    got = eng.serve(workload(), num_slots=4, chunk=4)
    for ra, rb in zip(want.results, got.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        np.testing.assert_array_equal(ra.trace, rb.trace)
    for s in eng._stores:
        assert s.total_bytes == s.observed_copy_bytes > 0
    sr = got.stream_report
    assert sr["degraded_tokens"] == 0 and sr["issued_copies"] > 0
    assert eng.num_graphs == 1
    eng.attach_controller(ControlConfig(
        enabled=True,
        bytes_per_token=0.5 * got.offload_report["bytes_per_token"]))
    budget = eng.serve(workload(), num_slots=4, chunk=4)
    assert len({p.tobytes() for p in budget.plan_trace}) > 1
    assert eng.num_graphs == 1
    for s in eng._stores:
        assert s.total_bytes == s.observed_copy_bytes


# ---------------------------------------------------------------------------
# speculative rounds on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_verify_round_equals_eager_round(dev, temperature):
    """Two speculative rounds from the same prefilled caches, drafts and
    generator on a graph engine (the first captures, the second replays)
    and on the eager loop: the same log-probs, traces, accepted lengths,
    next tokens, carry logits and rolled-back caches, bit for bit; the
    round ran the multi-query flash-decode mode and kernel 1, and the
    second round captured nothing."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine
    cfg, qp = _served("moe")
    prompts = _prompts(cfg, 3, 9)
    out = {}
    for graph in (True, False):
        eng = ServeEngine(cfg, qp, ServeConfig(temperature=temperature),
                          quantized=True, decode_graph=graph)
        logits, caches = eng.prefill(prompts, 12)
        t1 = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        gen = torch.Generator(device=dev).manual_seed(3)
        rounds = []
        n = (fd.launches.n, qm.launches.n)
        for r in range(2):
            draft = np.random.default_rng(r).integers(
                2, cfg.vocab_size, (3, 3)).astype(np.int32)
            res = eng.spec_round(logits, caches, t1, draft, generator=gen)
            logits = res.logits
            rounds.append([t.clone() for t in (res.logprobs, res.trace,
                                               res.acc_len, res.t1_next,
                                               logits)])
            t1 = res.t1_next.cpu().numpy()
        torch.cuda.synchronize()
        if not graph:
            assert fd.launches.n > n[0] and qm.launches.n > n[1]
        out[graph] = (rounds, [t.clone() for c in caches["layers"]
                               for t in c.values()] + [caches["pos"]],
                      eng.num_spec_graphs)
    assert out[True][2] == 1 and out[False][2] == 0
    for a, b in zip(out[True][0] + [out[True][1]],
                    out[False][0] + [out[False][1]]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("page_size", [0, 16])
def test_greedy_spec_serve_equals_plain_serve_on_card(dev, page_size):
    """Greedy speculation through the verify graph (n-gram drafts, k 3)
    gives the plain serve's tokens on the reduced f32 Mixtral,
    contiguous and paged, with one verify capture for the workload."""
    from repro_torch.serve import ServeEngine, synthetic_workload
    cfg, qp = _served("moe")
    stacks = [lp["moe"]["stacks"] for lp in qp["layers"] if "moe" in lp]

    def workload():
        return synthetic_workload(7, cfg.vocab_size, max_new=10, min_len=5,
                                  max_len=60, seed=6)

    eng = ServeEngine(cfg, qp, quantized=True)
    eng.attach_offload(stacks, cache_capacity=3)
    plain = eng.serve(workload(), num_slots=4, chunk=4, page_size=page_size)
    eng.attach_offload(stacks, cache_capacity=3)
    spec = eng.serve(workload(), num_slots=4, chunk=4, page_size=page_size,
                     spec_k=3)
    assert [r.tokens.tolist() for r in spec.results] == \
        [r.tokens.tolist() for r in plain.results]
    assert eng.num_spec_graphs == 1 and spec.chunk == 4
    assert 0.0 <= spec.spec_report["acceptance_rate"] <= 1.0


# ---------------------------------------------------------------------------
# training: the fused cross entropy and AdamW on the card
# ---------------------------------------------------------------------------

def _train_case(device):
    from repro_torch.config import ModelConfig
    from repro_torch.models.transformer import init_params
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
                      vocab_size=256, block_pattern=("global",),
                      tie_embeddings=False, max_position=256)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 41)).astype(np.int32)}
    return cfg, init_params(cfg, 0, torch.float32, "cpu"), batch


def test_fused_xent_grads_match_cpu(dev):
    """``lm_loss`` through the fused cross entropy (two padded chunks of
    16), on the card against the CPU from the same parameters: the loss
    within 1e-5, each gradient within 2e-2 of its max |g| (bf16
    cotangents, rounded from f32 logits that differ in the last place);
    and twice on the card bit for bit."""
    from repro_torch.models.model import lm_loss
    from repro_torch.models.transformer import ExecContext
    from repro_torch.train.microbatch import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    cfg, params, batch = _train_case("cpu")
    ctx = ExecContext(mode="train", remat=True)
    vg = value_and_grad(lambda p, b: lm_loss(p, b, cfg, ctx, loss_chunk=16))
    out = {}
    for where in ("cpu", "cuda", "cuda again"):
        d = torch.device(where.split()[0])
        out[where] = vg(tree_map(lambda t: t.to(d), params),
                        {k: torch.as_tensor(v, device=d)
                         for k, v in batch.items()})
    (lc, _), gc = out["cpu"]
    (lg, _), gg = out["cuda"]
    assert abs(float(lc) - float(lg)) <= 1e-5 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= \
            2e-2 * float(b.abs().max()) + 1e-7
    for a, b in zip(tree_leaves(gg), tree_leaves(out["cuda again"][1])):
        assert torch.equal(a, b)


def test_adamw_step_matches_cpu(dev):
    """One AdamW update (clipping on) from the same state and gradients:
    master, moments and the recast parameters on the card within 1e-6
    (relative) of the CPU's, or 1e-8 (about an ulp of a parameter of
    0.1) where an update cancels a parameter to near zero (the card
    contracts ``p - lr * u`` into one rounding)."""
    from repro_torch.config import TrainConfig
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map
    _, params, _ = _train_case("cpu")
    g = torch.Generator().manual_seed(1)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    out = {}
    for d in ("cpu", "cuda"):
        # copies: the update writes the params (and clips f32 grads) in
        # place
        p = tree_map(lambda t: t.to(d, copy=True), params)
        new, st, m = adamw_update(tree_map(lambda t: t.to(d, copy=True),
                                           grads), adamw_init(p), tcfg, p)
        out[d] = (new, st, m)
    for a, b in zip(tree_leaves(out["cuda"][:2]), tree_leaves(out["cpu"][:2])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-8)
    assert float(out["cuda"][2]["grad_norm"]) == pytest.approx(
        float(out["cpu"][2]["grad_norm"]), rel=1e-6)


# ---------------------------------------------------------------------------
# expert parallelism: kernel 1 on a shard's experts, a 2-rank mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("c", [4, 130])
def test_fused_kernel_on_local_slices_matches_full_rows(dev, c, ep):
    """Each shard's experts (their own widths and ranks) through kernel 1
    give the full-E call's rows for those experts, on the decode kernel
    (C 4) and the tensor-core tile (C 130)."""
    E, R = 8, 48
    args = list(_fused_args(dev, E, c, 256, 260, R, 3, gated=True, cap=None,
                            eb=[3, 2, 1, 3, 2, 3, 1, 2], seed=c + ep))
    args[12] = torch.tensor([R, 0, R // 2, 7, R, 1, 0, 30],
                            dtype=torch.int32, device=dev)
    full = qm.fused_expert_matmul(*args, bits=3, group_size=64,
                                  require_kernel=True)
    el = E // ep
    for s in range(ep):
        lo, hi = s * el, (s + 1) * el
        sl = [a if a is None or i == 10 else
              (tuple(p[lo:hi] for p in a) if isinstance(a, tuple)
               else a[lo:hi]) for i, a in enumerate(args)]
        got = qm.fused_expert_matmul(*sl, bits=3, group_size=64,
                                     require_kernel=True)
        want = qm.fused_expert_matmul_plain(*sl, bits=3, group_size=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, full[lo:hi], **FUSED_TOL)
        torch.testing.assert_close(got, want, **FUSED_TOL)


def test_mesh_generate_matches_single_device_on_card(dev, tmp_path):
    """Reduced Mixtral-8x7B on a 2-rank gloo mesh, both ranks on cuda:0,
    each with its slice of the experts from an artifact: the single-device
    eager loop's tokens and router trace, log-probs within 1e-5 (top-2
    over 2 ranks: each token's sum has at most two nonzero terms)."""
    import torch_ep_worker
    from repro_torch.calib import save_compression_artifact
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import (compress_moe_params,
                                                init_params)
    from repro_torch.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("mixtral-8x7b", reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    qp, cfg_q, stacks = compress_moe_params(params, cfg)
    save_compression_artifact(tmp_path, cfg_q, stacks, seed=0)
    prompts = _prompts(cfg, 3, 21)
    want = ServeEngine(cfg_q, qp, quantized=True, decode_graph=False) \
        .generate(prompts, 8)
    ranks = run_ranks(torch_ep_worker.card_ranks, 2, backend="gloo",
                      args=({"cfg": cfg, "cfg_q": cfg_q, "art": str(tmp_path),
                             "prompts": prompts, "new": 8},))
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], want.tokens)
        np.testing.assert_array_equal(r["trace"], want.router_trace)
        np.testing.assert_allclose(r["logprobs"], want.logprobs, rtol=1e-5,
                                   atol=1e-5)
        assert r["comm_calls"] > 0
