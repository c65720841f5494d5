"""PyTorch port vs the JAX package on the dense-FFN path: the quantized
matmul (``ops.quant_matmul`` / ``ops.lowrank_comp_matmul``), the dense
FFN and its E = 1 quantized form, and decode attention on a row with no
valid slot.

The port runs on the CPU here, so its kernel wrapper takes its plain
version; the JAX side runs its pure-jnp oracle (and, for one case per
function, its Pallas kernel under the interpreter).  Inputs are made with
numpy from a seed; quantized matrices are built by JAX and carried across
by ``repro_torch.bridge``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig
from repro.core import quantize
from repro.core.pipeline import compress_ffn_weights as j_compress_ffn
from repro.kernels import ops as jops
from repro.models.attention import decode_attention as j_decode
from repro.models.ffn import ffn_apply as j_ffn
from repro.models.ffn import ffn_apply_quantized as j_ffn_q
from repro_torch.bridge import stack_to_torch, to_torch, tree_to_torch
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import decode_attention as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models.attention import decode_attention as t_decode
from repro_torch.models.ffn import ffn_apply, ffn_apply_quantized

# the JAX package's own tolerance between its oracle and its Pallas kernel
# (tests/test_kernels_quant_matmul.py): f32 sums in another order
TOL = dict(rtol=1e-4, atol=1e-3)
# the JAX interpreter's tiles for these shapes (same test file)
JTILES = dict(bm=32, bn=128, bk=128)


def _qt(rng, k, n, bits):
    """A JAX-quantized (k, n) matrix and its bridged twin."""
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    jq = quantize(w, bits, 64)
    tq = QuantizedTensor(tuple(to_torch(np.asarray(p), "cpu")
                               for p in jq.planes),
                         to_torch(np.asarray(jq.scale), "cpu"),
                         to_torch(np.asarray(jq.zero), "cpu"), bits, 64,
                         (k, n))
    return jq, tq


def _factors(rng, k, n, rank):
    u = rng.integers(-127, 127, (k, rank)).astype(np.int8)
    v = rng.integers(-127, 127, (rank, n)).astype(np.int8)
    us = rng.random((1, rank)).astype(np.float32) * 0.01
    vs = rng.random((rank, 1)).astype(np.float32) * 0.01
    return u, v, us, vs


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (96, 512, 384),
                                   (33, 256, 128)])
def test_quant_matmul_matches_jax(bits, m, k, n):
    rng = np.random.default_rng(bits * 1000 + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, tq = _qt(rng, k, n, bits)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jq, impl="ref"))
    for impl in ("auto", "ref"):
        got = tops.quant_matmul(torch.from_numpy(x), tq, impl=impl).numpy()
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"port {impl} vs JAX ref")


def test_quant_matmul_matches_jax_pallas():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((33, 256)).astype(np.float32)
    jq, tq = _qt(rng, 256, 128, 3)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jq,
                                        impl="pallas_interpret", **JTILES))
    got = tops.quant_matmul(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _lowrank_both(bits, rank, rank_cap=None, seed=0, m=64, k=384, n=256,
                  jimpl="ref"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, tq = _qt(rng, k, n, bits)
    u, v, us, vs = _factors(rng, k, n, rank)
    mask = (rng.random(m) < 0.5).astype(np.float32)
    kw = {} if jimpl == "ref" else JTILES
    want = np.asarray(jops.lowrank_comp_matmul(
        jnp.asarray(x), jq, *map(jnp.asarray, (u, v, us, vs, mask)),
        impl=jimpl, rank_cap=None if rank_cap is None
        else jnp.int32(rank_cap), **kw))
    targs = [torch.from_numpy(a) for a in (u, v, us, vs, mask)]
    for impl in ("auto", "ref"):
        got = tops.lowrank_comp_matmul(torch.from_numpy(x), tq, *targs,
                                       impl=impl, rank_cap=rank_cap).numpy()
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"port {impl} vs JAX {jimpl}")
    return want


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("rank", [8, 32, 96])
def test_lowrank_comp_matmul_matches_jax(bits, rank):
    _lowrank_both(bits, rank, seed=rank)


def test_lowrank_comp_matmul_rank_cap_matches_jax():
    capped = _lowrank_both(2, 32, rank_cap=11, seed=4)
    full = _lowrank_both(2, 32, seed=4)
    assert not np.allclose(capped, full)


def test_lowrank_comp_matmul_matches_jax_pallas():
    _lowrank_both(3, 32, rank_cap=20, seed=9, jimpl="pallas_interpret")


def test_quant_matmul_cuda_impl_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    _, tq = _qt(rng, 128, 128, 2)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        tops.quant_matmul(x, tq, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul(x, tq.planes, tq.scale, tq.zero, bits=2,
                         group_size=64, require_kernel=True)


def test_qmm_splits_fill_the_card_at_decode():
    """Llama-3.2-3B's projections at decode (M = 4): at least two blocks
    per SM, at least 8 pack blocks (one per warp) per split, the splits
    covering K exactly; prefill needs no split."""
    for k, n in ((3072, 8192), (8192, 3072)):
        ks, kch = tqm.qmm_splits(4, k, n)
        n_pb = k // 64
        assert (n // 128) * ks >= 264
        assert kch >= 8 and (ks - 1) * kch < n_pb <= ks * kch
        assert tqm.qmm_splits(1024, k, n)[0] == 1


def _kernel_mma_min_m() -> int:
    """``kMmaMinM`` as ``csrc/quant_matmul.cu`` defines it."""
    import re
    from pathlib import Path
    src = (Path(tqm.__file__).parent / "csrc" / "quant_matmul.cu").read_text()
    return int(re.search(r"constexpr int kMmaMinM = (\d+);", src).group(1))


@pytest.mark.parametrize("m", [1, 4, "below", "at", "above", 1024])
def test_qmm_path_choice_mirrors_the_kernel(m):
    """The wrapper's mirror of the kernel's path choice: the CUDA-core
    split-K path below ``kMmaMinM`` tokens, with the decode splits of
    Llama-3.2-3B unchanged (5 for w1/w3, 11 for w2 at M 4), and the
    tensor-core path, one split of all K/64 pack blocks, from it."""
    t = _kernel_mma_min_m()
    assert tqm.MMA_MIN_M == t
    m = {"below": t - 1, "at": t, "above": t + 1}.get(m, m)
    for k, n, decode_splits in ((3072, 8192, 5), (8192, 3072, 11)):
        ks, kch = tqm.qmm_splits(m, k, n)
        if m < t:
            assert tqm.qmm_path(m) == "splitk"
            assert (ks, kch) == tqm.qmm_splits(m, k, n, "splitk")
            assert (ks - 1) * kch < k // 64 <= ks * kch
            if m == 4:
                assert ks == decode_splits
        else:
            assert tqm.qmm_path(m) == "mma"
            assert (ks, kch) == (1, k // 64)


# ---------------------------------------------------------------------------
# dense FFN, plain and E = 1 quantized
# ---------------------------------------------------------------------------

_FFN = {}


def _ffn_weights():
    """(numpy w1/w3/w2, JAX E = 1 stacks, bridged stacks) built once."""
    if not _FFN:
        rng = np.random.default_rng(17)
        d, ff = 128, 192
        w = {"w1": rng.standard_normal((d, ff)) / np.sqrt(d),
             "w3": rng.standard_normal((d, ff)) / np.sqrt(d),
             "w2": rng.standard_normal((ff, d)) / np.sqrt(ff)}
        w = {k: a.astype(np.float32) for k, a in w.items()}
        qcfg = QuantConfig(enabled=True, bits=2, group_size=64,
                           rank_budget=16, hqq_iters=3)
        js, _ = j_compress_ffn(*(jnp.asarray(w[k])[None]
                                 for k in ("w1", "w2", "w3")), qcfg)
        ts = tree_to_torch(jax.tree.map(np.asarray, js), "cpu")
        _FFN.update(w=w, js=js, ts=ts)
    return _FFN


def test_ffn_apply_matches_jax():
    f = _ffn_weights()
    x = np.random.default_rng(2).standard_normal((2, 5, 128)) \
        .astype(np.float32)
    want = np.asarray(j_ffn(jnp.asarray(x), {k: jnp.asarray(a)
                                             for k, a in f["w"].items()}))
    got = ffn_apply(torch.from_numpy(x), {k: torch.from_numpy(a)
                                          for k, a in f["w"].items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compensate", [True, False])
def test_ffn_apply_quantized_matches_jax(compensate):
    f = _ffn_weights()
    assert f["ts"]["w1"].shape == (1, 128, 192)
    assert f["ts"]["w1"].ranks == (16,)
    x = np.random.default_rng(3).standard_normal((2, 5, 128)) \
        .astype(np.float32)
    want = np.asarray(j_ffn_q(jnp.asarray(x), f["js"], compensate=compensate,
                              impl="ref"))
    for impl in ("auto", "ref"):
        got = ffn_apply_quantized(torch.from_numpy(x), f["ts"],
                                  compensate=compensate, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"port {impl}")


def test_stack_member_is_a_view():
    """Slicing expert 0 out of an E = 1 stack copies nothing."""
    st = _ffn_weights()["ts"]["w2"]
    qt = tops.stack_member(st, 0)
    for a, b in zip(qt.planes + (qt.scale, qt.zero),
                    st.planes + (st.scale, st.zero)):
        assert a.data_ptr() == b.data_ptr() and a.is_contiguous()
    assert st.u[0].data_ptr() == st.u.data_ptr()


def test_compensated_matmul_stack_matches_jax():
    rng = np.random.default_rng(23)
    w = jnp.asarray(rng.standard_normal((3, 128, 64)).astype(np.float32))
    qcfg = QuantConfig(enabled=True, bits=3, group_size=64, rank_budget=16,
                       hqq_iters=2)
    js, _ = j_compress_ffn(w, w, None, qcfg)
    ts = stack_to_torch(js["w1"], "cpu")
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32)
    want = np.asarray(jops.compensated_matmul_stack(
        jnp.asarray(x), js["w1"], jnp.asarray(mask), impl="ref",
        rank_cap=jnp.int32(9)))
    got = tops.compensated_matmul_stack(torch.from_numpy(x), ts,
                                        torch.from_numpy(mask), rank_cap=9)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# decode attention: a row with no valid slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_fully_masked_row_matches_jax(int8):
    """A row whose every slot is empty: JAX's ``decode_attention`` (finite
    mask bias) and the port give the mean of V over the row's slots; the
    other rows are unaffected."""
    from repro.models.kvcache import _kv_quant as j_kv_quant
    rng = np.random.default_rng(29)
    b, s, kvh, g, hd = 3, 64, 2, 3, 32
    q = rng.standard_normal((b, 1, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    pos = np.where(np.arange(s) < 40, np.arange(s), -1)[None] \
        .repeat(b, 0).astype(np.int32)
    pos[1] = -1
    cur = np.full((b,), 39, np.int32)
    jk, jv, ks, vs = jnp.asarray(k), jnp.asarray(v), None, None
    if int8:
        jk, ks = j_kv_quant(jk)
        jv, vs = j_kv_quant(jv)
    want = np.asarray(j_decode(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                               jnp.asarray(cur), k_scale=ks, v_scale=vs))
    tk, tv = to_torch(np.asarray(jk), "cpu"), to_torch(np.asarray(jv), "cpu")
    tks = None if ks is None else to_torch(np.asarray(ks), "cpu")
    tvs = None if vs is None else to_torch(np.asarray(vs), "cpu")
    tp, tc = torch.from_numpy(pos), torch.from_numpy(cur)
    for impl in ("auto", "ref"):
        got = t_decode(torch.from_numpy(q), tk, tv, tp, tc, k_scale=tks,
                       v_scale=tvs, impl=impl).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=f"port {impl}")
    vd = tv.float() * (1.0 if tvs is None else tvs.float()[..., None])
    mean_v = vd[1].mean(dim=0).repeat_interleave(g, dim=0).numpy()
    np.testing.assert_allclose(want[1, 0], mean_v, rtol=2e-5, atol=2e-5)
    plain = tfd.flash_decode_attention_plain(
        torch.from_numpy(q[:, 0]) / np.sqrt(hd), tk, tv, tp, tc, tks, tvs)
    np.testing.assert_allclose(plain.numpy(), want[:, 0], rtol=2e-5,
                               atol=2e-5)
