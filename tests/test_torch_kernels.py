"""PyTorch port vs the JAX package: the two kernel modules' functions.

The port runs on the CPU here, so its kernel wrappers take their plain
versions; the JAX side runs its pure-jnp oracle and its Pallas kernel
under the interpreter.  Same inputs (numpy, from a seed) and the same
JAX-compressed stacks (moved by ``repro_torch.bridge``) on both sides.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig
from repro.core.pipeline import compress_expert_stack
from repro.kernels import ops as jops
from repro.kernels.decode_attention import flash_decode_attention as j_flash
from repro.models.attention import decode_attention as j_decode
from repro.models.kvcache import _kv_quant as j_kv_quant
from repro_torch.bridge import stack_to_torch
from repro_torch.kernels import decode_attention as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models.attention import decode_attention as t_decode

TOL = dict(rtol=1e-4, atol=1e-3)      # tests/test_fused_kernel.py:28
_STACKS = {}


def _stack(bits=2, expert_bits=None):
    """JAX-compressed (E=4, K=128, N=128) stack and its bridged twin."""
    key = (bits, expert_bits)
    if key not in _STACKS:
        rng = np.random.default_rng(0)
        qcfg = QuantConfig(enabled=True, bits=bits, group_size=64,
                           rank_budget=8, top_n_restore=1, hqq_iters=2)
        w = jnp.asarray(rng.standard_normal((4, 128, 128)),
                        jnp.float32) * 0.05
        js, _ = compress_expert_stack(
            w, qcfg, bits=None if expert_bits is None
            else np.asarray(expert_bits))
        _STACKS[key] = (js, stack_to_torch(js, "cpu"))
    return _STACKS[key]


def _inputs(e, c, k, mask_mode, gated, seed):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((e, c, k)).astype(np.float32)
    me = {"none": np.zeros((e, c), np.float32),
          "partial": (rng.random((e, c)) < 0.5).astype(np.float32),
          "all": np.ones((e, c), np.float32)}[mask_mode]
    ge = rng.random((e, c)).astype(np.float32) if gated else None
    return xe, me, ge


def _fused_parity(bits, xe, me, ge, cap, expert_bits=None):
    js, ts = _stack(bits, expert_bits)
    jcap = None if cap is None else jnp.int32(cap)
    jarg = dict(gates=None if ge is None else jnp.asarray(ge),
                rank_cap=jcap, out_dtype=jnp.float32)
    want = {impl: np.asarray(jops.fused_expert_matmul(
        jnp.asarray(xe), js, jnp.asarray(me), impl=impl, **jarg))
        for impl in ("ref", "pallas_interpret")}
    targ = dict(gates=None if ge is None else torch.from_numpy(ge),
                rank_cap=cap, out_dtype=torch.float32)
    for impl in ("auto", "ref"):
        got = tops.fused_expert_matmul(torch.from_numpy(xe), ts,
                                       torch.from_numpy(me), impl=impl,
                                       **targ).numpy()
        for jimpl, w in want.items():
            np.testing.assert_allclose(got, w, **TOL,
                                       err_msg=f"port {impl} vs JAX {jimpl}")


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("rank_mode", ["zero", "half", "full"])
def test_fused_parity_bits_x_rank(bits, rank_mode):
    js, _ = _stack(bits)
    xe, me, ge = _inputs(4, 8, 128, "partial", gated=True, seed=bits)
    cap = {"zero": 0, "half": js.pad_rank // 2, "full": None}[rank_mode]
    _fused_parity(bits, xe, me, ge, cap)


@pytest.mark.parametrize("mask_mode", ["none", "partial", "all"])
@pytest.mark.parametrize("gated", [False, True])
def test_fused_parity_topn_x_gates(mask_mode, gated):
    js, _ = _stack(2)
    xe, me, ge = _inputs(4, 8, 128, mask_mode, gated, seed=7)
    _fused_parity(2, xe, me, ge, js.pad_rank // 2)


def test_fused_parity_heterogeneous_expert_bits():
    js, ts = _stack(3, (2, 3, 2, 3))
    assert ts.expert_bits == js.expert_bits == (2, 3, 2, 3)
    xe, me, ge = _inputs(4, 8, 128, "partial", gated=True, seed=11)
    _fused_parity(3, xe, me, ge, None, (2, 3, 2, 3))


@pytest.mark.parametrize("c", [1, 5])
def test_fused_parity_ragged_capacity(c):
    xe, me, ge = _inputs(4, c, 128, "partial", gated=True, seed=13 + c)
    _fused_parity(4, xe, me, ge, 3)


def test_fused_plain_masks_sub_width_planes():
    """The kernel's plain version masks planes at or above expert_bits:
    a 2-bit expert ignores garbage in the 1-bit plane of a 3-bit
    container (the JAX oracle relies on that plane being zero)."""
    _, ts = _stack(3, (2, 3, 2, 3))
    xe, me, ge = _inputs(4, 4, 128, "all", gated=False, seed=3)
    x, m = torch.from_numpy(xe), torch.from_numpy(me)
    clean = tops.fused_expert_matmul(x, ts, m, impl="auto")
    planes = list(ts.planes)
    planes[1] = planes[1].clone()
    planes[1][0] = 0xFF                   # expert 0 is 2-bit
    dirty = type(ts)(**{**ts.__dict__, "planes": tuple(planes),
                        "_meta": {}})
    got = tops.fused_expert_matmul(x, dirty, m, impl="auto")
    np.testing.assert_array_equal(got[0].numpy(), clean[0].numpy())
    assert not np.allclose(got[1].numpy(), 0)


def test_cuda_impl_refuses_cpu_tensors():
    _, ts = _stack(2)
    xe, me, _ = _inputs(4, 2, 128, "all", False, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        tops.fused_expert_matmul(torch.from_numpy(xe), ts,
                                 torch.from_numpy(me), impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.resolve_impl("pallas")


def _kernel_fused_mma_min_c() -> int:
    """``kFusedMmaMinC`` as ``csrc/fused_expert.cu`` defines it."""
    src = (Path(tqm.__file__).parent / "csrc" / "fused_expert.cu").read_text()
    return int(re.search(r"constexpr int kFusedMmaMinC = (\d+);",
                         src).group(1))


@pytest.mark.parametrize("c", [1, 4, "below", "at", "above", 1024])
def test_fused_path_choice_mirrors_the_kernel(c):
    """The wrapper's mirror of the fused kernel's path choice: the CUDA
    cores below ``kFusedMmaMinC`` (decode, C = batch 4, among them), the
    tensor cores from it (exact-capacity prefill, C = 4 x 256)."""
    t = _kernel_fused_mma_min_c()
    assert tqm.FUSED_MMA_MIN_C == t
    c = {"below": t - 1, "at": t, "above": t + 1}.get(c, c)
    assert tqm.fused_path(c) == ("mma" if c >= t else "simt")
    assert tqm.fused_path(4) == "simt" and tqm.fused_path(1024) == "mma"


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _attn_setup(b=2, s=256, kvh=2, g=3, hd=32, filled=200, seed=0):
    rng = np.random.default_rng(seed)
    h = kvh * g
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    ar = np.arange(s)[None, :]
    pos = (np.where(ar < filled, ar, -1) + np.zeros((b, 1))).astype(np.int32)
    cur = np.full((b,), filled - 1, np.int32)
    return q, k, v, pos, cur


def _check_decode(q, k, v, pos, cur, window=None, int8=False, tol=2e-5):
    ks = vs = None
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if int8:
        jk, jks = j_kv_quant(jk)
        jv, jvs = j_kv_quant(jv)
        ks, vs = jks, jvs
    ref = np.asarray(j_decode(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                              jnp.asarray(cur), window=window, k_scale=ks,
                              v_scale=vs))[:, 0]
    hd = q.shape[-1]
    flash = np.asarray(j_flash(jnp.asarray(q[:, 0]) / math.sqrt(hd), jk, jv,
                               jnp.asarray(pos), jnp.asarray(cur),
                               k_scale=ks, v_scale=vs, window=window,
                               bs=64, interpret=True))
    from repro_torch.bridge import to_torch
    tk, tv = to_torch(np.asarray(jk), "cpu"), to_torch(np.asarray(jv), "cpu")
    tks = None if ks is None else to_torch(np.asarray(ks), "cpu")
    tvs = None if vs is None else to_torch(np.asarray(vs), "cpu")
    if int8:  # the port's own quantizer writes the same codes and scales
        from repro_torch.models.kvcache import _kv_quant
        qk, sk = _kv_quant(torch.from_numpy(k))
        assert torch.equal(qk, tk) and torch.equal(sk, tks)
    tp, tc = torch.from_numpy(pos), torch.from_numpy(cur)
    for impl in ("auto", "ref"):
        got = t_decode(torch.from_numpy(q), tk, tv, tp, tc, window=window,
                       k_scale=tks, v_scale=tvs, impl=impl)[:, 0].numpy()
        for name, want in (("decode_attention", ref), ("flash", flash)):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=f"port {impl} vs JAX {name}")
    # the kernel module's plain version, fed the pre-scaled query
    got = tfd.flash_decode_attention(torch.from_numpy(q[:, 0])
                                     / math.sqrt(hd), tk, tv, tp, tc, tks,
                                     tvs, window=window).numpy()
    np.testing.assert_allclose(got, flash, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_matches_jax(window):
    _check_decode(*_attn_setup(), window=window)


def test_decode_attention_int8_kv_matches_jax():
    _check_decode(*_attn_setup(seed=3), int8=True, tol=1e-4)


def test_decode_attention_empty_slots_match_jax():
    _check_decode(*_attn_setup(filled=10, seed=7))


def test_decode_attention_step_positions_2d():
    """decode_step passes positions as (B, 1); the kernel path squeezes
    them to (B,)."""
    q, k, v, pos, cur = _attn_setup(seed=9)
    tq_, tk, tv = map(torch.from_numpy, (q, k, v))
    tp = torch.from_numpy(pos)
    a = t_decode(tq_, tk, tv, tp, torch.from_numpy(cur)[:, None])
    b = t_decode(tq_, tk, tv, tp, torch.from_numpy(cur), impl="ref")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 100])
def test_decode_attention_ring_positions_match_jax(window):
    """A ring cache that wrapped: every slot written, positions out of
    order (slot s holds the newest position p <= cur with p % S == s)."""
    q, k, v, _, _ = _attn_setup(seed=11)
    s = k.shape[1]
    c = s + s // 3
    pos = np.broadcast_to(c - (c - np.arange(s)) % s, (q.shape[0], s))
    assert not np.all(np.diff(pos[0]) > 0)
    cur = np.full((q.shape[0],), c, np.int32)
    _check_decode(q, k, v, np.ascontiguousarray(pos, np.int32), cur,
                  window=window)


def _kernel_flash_constants() -> dict:
    """kWarps, kStageBytes and kMaxCluster as ``csrc/flash_decode.cu``
    defines them."""
    src = (Path(tfd.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kWarps", "kStageBytes", "kMaxCluster")}


@pytest.mark.parametrize("b,kvh,s", [(4, 8, 512), (4, 8, 32768),
                                     (1, 8, 512), (1, 1, 7), (2, 4, 1003),
                                     (20, 8, 96), (64, 8, 4096),
                                     (3, 2, 200)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_flash_geometry_mirrors_the_kernel(b, kvh, s, sms):
    """The host's launch geometry against what the kernel assumes: the
    constants agree with the source; the grid is at most one resident
    wave (or CL is 1); no block of a cluster is left without slots; every
    slot is read by exactly one block."""
    const = _kernel_flash_constants()
    assert tfd.WARPS == const["kWarps"]
    assert tfd.STAGE_BYTES == const["kStageBytes"]
    assert max(tfd.CLUSTERS) == const["kMaxCluster"]
    def cap(cl):                      # two blocks on each SM
        return sms * 2 // cl

    for hd, elem in ((128, 4), (128, 2), (128, 1), (256, 4), (32, 1)):
        spw = tfd.slots_per_warp(hd, elem)
        assert spw & (spw - 1) == 0 and 1 <= spw <= 32
        cl = tfd.launch_geometry(b * kvh, s, spw, cap)
        assert cl in tfd.CLUSTERS
        assert cl == 1 or b * kvh * cl <= sms * 2
        blocks = tfd.block_slots(s, spw, cl)
        assert len(blocks) == cl and all(blocks)
        assert sorted(x for blk in blocks for x in blk) == list(range(s))
    # Mixtral at batch 4 on an H100: 32 rows, a cluster of 8 at any S
    # from the slice's 512; f32 hd 128 takes 4 slots per warp tile
    assert tfd.slots_per_warp(128, 4) == 4
    assert tfd.launch_geometry(32, 512, 4, lambda cl: 264 // cl) == 8


def test_moe_dispatch_matches_jax_and_counts_rows():
    """Routing, slots, dispatched buffers and gates equal JAX's; ``rows``
    counts each expert's occupied leading slots, and the kernel wrapper
    given ``rows`` computes what it computes without them."""
    from repro.config import MoEConfig as JMoE
    from repro.models import moe as jmoe
    from repro_torch.config import MoEConfig
    from repro_torch.models import moe as tmoe
    rng = np.random.default_rng(21)
    x = rng.standard_normal((12, 32)).astype(np.float32)
    wr = rng.standard_normal((32, 8)).astype(np.float32)
    jm, tm = JMoE(8, 2, 64), MoEConfig(8, 2, 64)
    jinfo = jmoe.route(jnp.asarray(x), jnp.asarray(wr), jm)
    tinfo = tmoe.route(torch.from_numpy(x), torch.from_numpy(wr), tm)
    np.testing.assert_array_equal(tinfo.topk_idx.numpy(),
                                  np.asarray(jinfo.topk_idx))
    jd = jmoe.make_dispatch(jinfo, 8, 12, 1)
    td = tmoe.make_dispatch(tinfo, 8, 12, 1)
    np.testing.assert_array_equal(td.slot.numpy(), np.asarray(jd.slot))
    jxe, jme = jmoe.dispatch_tokens(jnp.asarray(x), jd, 8)
    txe, tme = tmoe.dispatch_tokens(torch.from_numpy(x), td, 8)
    np.testing.assert_array_equal(txe.numpy(), np.asarray(jxe))
    np.testing.assert_array_equal(tme.numpy(), np.asarray(jme))
    np.testing.assert_allclose(tmoe.dispatch_gates(td, 8).numpy(),
                               np.asarray(jmoe.dispatch_gates(jd, 8)),
                               rtol=1e-5)      # softmax summed in f32
    from repro.core.restoration import topn_mask as j_topn
    from repro_torch.core.restoration import topn_mask as t_topn
    np.testing.assert_array_equal(
        t_topn(tinfo.topk_idx, 1, 8).numpy(),
        np.asarray(j_topn(jinfo.topk_idx, 1, 8)))
    counts = np.bincount(np.asarray(jd.e_idx), minlength=8)
    np.testing.assert_array_equal(td.rows.numpy(), counts)
    occupied = (np.abs(np.asarray(jxe)).sum(-1) > 0).sum(-1)
    np.testing.assert_array_equal(td.rows.numpy(), occupied)

    _, ts = _stack(2)
    xe = torch.from_numpy(rng.standard_normal((4, 6, 128))
                          .astype(np.float32))
    rows = torch.tensor([0, 6, 2, 5], dtype=torch.int32)
    live = (torch.arange(6)[None] < rows[:, None]).float()
    xe, me = xe * live[:, :, None], live
    a = tops.fused_expert_matmul(xe, ts, me, rows=rows)
    b = tops.fused_expert_matmul(xe, ts, me)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
