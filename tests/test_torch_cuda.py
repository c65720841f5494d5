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


def test_flash_decode_kernel_fully_masked_row_is_zero(dev):
    """A row with no valid slot gives zeros from the kernel (the plain
    version's softmax over equal masked scores gives the mean of V); the
    other rows still match the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, KVH, hd, S = 3, 8, 2, 128, 96
    q = torch.randn((B, H, hd), generator=g, device=dev) / math.sqrt(hd)
    k = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    v = torch.randn((B, S, KVH, hd), generator=g, device=dev)
    ar = torch.arange(S, device=dev, dtype=torch.int32)
    pos = torch.where(ar < 40, ar, -1)[None].repeat(B, 1)
    pos[1] = -1
    cur = torch.full((B,), 39, dtype=torch.int32, device=dev)
    got = fd.flash_decode_attention(q, k, v, pos, cur, require_kernel=True)
    want = fd.flash_decode_attention_plain(q, k, v, pos, cur)
    torch.cuda.synchronize()
    assert float(got[1].abs().max()) == 0.0
    torch.testing.assert_close(got[1], torch.zeros_like(got[1]))
    torch.testing.assert_close(want[1], v[1].mean(dim=0).repeat_interleave(
        H // KVH, dim=0), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=2e-5,
                               rtol=2e-5)


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
