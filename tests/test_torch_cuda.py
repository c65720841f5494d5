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


def _fused_args(dev, E, C, K, N, R, bits, gated, cap, eb, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rint(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32).to(dt)

    planes = tuple(rint(0, 256, (E, K * p // 8, N), torch.uint8)
                   for p, _ in PLANES[bits])
    scale = torch.rand((E, K // 64, N), generator=g, device=dev) * 0.02
    zero = torch.rand((E, K // 64, N), generator=g, device=dev) * 3
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


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("c", [1, 3, 8, 21])
def test_fused_kernel_matches_plain(dev, bits, c):
    eb = [bits, max(1, bits - 1), bits, bits]
    args = _fused_args(dev, 4, c, 256, 260, 48, bits, gated=c % 2 == 1,
                       cap=[None, 0, 17, 48][c % 4], eb=eb, seed=bits * c)
    before = qm.launches.n
    got = qm.fused_expert_matmul(*args, bits=bits, group_size=64,
                                 require_kernel=True)
    assert qm.launches.n == before + 1
    want = qm.fused_expert_matmul_plain(*args, bits=bits, group_size=64)
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


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,filled", [(None, 150), (40, 150),
                                           (None, 3)])
def test_flash_decode_kernel_matches_plain(dev, kind, window, filled):
    from repro_torch.models.kvcache import _kv_quant
    g = torch.Generator(device=dev).manual_seed(filled)
    B, H, KVH, hd, S = 3, 12, 2, 64, 200
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    pos = torch.where(ar < filled, ar, -1)[None].repeat(B, 1)
    cur = torch.full((B,), filled - 1, dtype=torch.int32, device=dev)
    ks = vs = None
    if kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif kind == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    got = fd.flash_decode_attention(q, k, v, pos, cur, ks, vs, window=window,
                                    require_kernel=True)
    want = fd.flash_decode_attention_plain(q, k, v, pos, cur, ks, vs, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


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
