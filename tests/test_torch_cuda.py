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


@pytest.mark.parametrize("c", [1, 4, 37])
def test_fused_kernel_skips_empty_slots(dev, c):
    """rows[e] = occupied leading slots: tiles past it and idle experts
    give zeros without reading weights, as the plain version computes."""
    args = list(_fused_args(dev, 4, c, 128, 256, 32, 2, gated=True,
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
# (4, 512) and (4, 1024) buckets
_FLASH_SHAPES = {"qwen3_s512": (4, 32, 4, 128, 512),
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
