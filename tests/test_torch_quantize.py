"""PyTorch port vs the JAX package: packing, codes and compression.

Packed bytes and integer codes must be bit-identical; offline
compression (HQQ float order, SVD sign) is not bit-stable across
frameworks, so it is held to the JAX package's quantization and
restoration error on the same weights.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantConfig as JQuantConfig
from repro.core.pipeline import compress_expert_stack as j_compress
from repro_torch.config import QuantConfig
from repro_torch.core import hqq as thqq
from repro_torch.core import quantize as tq
from repro_torch.core.pipeline import compress_expert_stack as t_compress

# repro.core re-exports functions named like its modules; load the modules
jhqq = importlib.import_module("repro.core.hqq")
jq = importlib.import_module("repro.core.quantize")


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, (256, 48)).astype(np.uint8)
    jp = jq.pack_bits(jnp.asarray(q), bits)
    tp = tq.pack_bits(torch.from_numpy(q), bits)
    assert len(jp) == len(tp) == len(tq.PLANES[bits])
    for a, b in zip(jp, tp):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(tq.unpack_bits(tp, bits).numpy(), q)
    assert tq.packed_nbytes(bits, 256, 48) == jq.packed_nbytes(bits, 256, 48)
    assert sum(p.numel() for p in tp) == tq.packed_nbytes(bits, 256, 48)


@pytest.mark.parametrize("bits,store", [(1, None), (2, None), (2, 3),
                                        (3, None), (4, None), (2, 4),
                                        (8, None)])
def test_quantize_with_params_bit_identical(bits, store):
    rng = np.random.default_rng(10 + bits)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    s, z = jhqq.hqq_params(jnp.asarray(w), bits, 64, 3)
    s, z = np.array(s), np.array(z)
    jt = jq.quantize_with_params(jnp.asarray(w), jnp.asarray(s),
                                 jnp.asarray(z), bits, 64, store_bits=store)
    # the port's route: codes, then packed into the container width
    codes = tq.quantize_codes(torch.from_numpy(w), torch.from_numpy(s),
                              torch.from_numpy(z), bits, 64)
    planes = tq.pack_bits(codes, store or bits)
    assert jt.bits == (store or bits)
    assert len(planes) == len(jt.planes)
    for a, b in zip(jt.planes, planes):
        assert np.array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize(jt)),
        tq.dequantize_codes(tq.unpack_bits(planes, store or bits),
                            torch.from_numpy(s), torch.from_numpy(z),
                            64).numpy())


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_hqq_params_match(bits):
    rng = np.random.default_rng(20 + bits)
    w = (rng.standard_normal((128, 96)) * 0.02).astype(np.float32)
    js, jz = jhqq.hqq_params(jnp.asarray(w), bits, 64, 5)
    ts, tz = thqq.hqq_params(torch.from_numpy(w), bits, 64, 5)
    # elementwise f32 in both; only reduction order differs
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bits,k,n", [(2, 128, 64), (3, 64, 128)])
def test_wire_bytes_formulas_match(bits, k, n):
    assert tq.quant_wire_bytes(bits, k, n, 64) == \
        jq.quant_wire_bytes(bits, k, n, 64)
    assert tq.factor_wire_bytes(16, k, n, 8) == \
        jq.factor_wire_bytes(16, k, n, 8)


def _heavy_tailed(e, k, n, seed):
    """Experts with distinct tails (Student-t, falling df) so kurtosis
    orders them unambiguously in both frameworks."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.standard_t(3 + 4 * i, (k, n)) * 0.02
                     for i in range(e)]).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 3])
def test_compression_within_jax_error(bits):
    w = _heavy_tailed(4, 128, 128, seed=bits)
    kw = dict(enabled=True, bits=bits, group_size=64, rank_budget=16,
              top_n_restore=1, hqq_iters=4)
    jstack, jrep = j_compress(jnp.asarray(w), JQuantConfig(**kw))
    tstack, trep = t_compress(torch.from_numpy(w), QuantConfig(**kw))
    assert tstack.ranks == jstack.ranks
    assert tstack.pad_rank == jstack.pad_rank
    assert tstack.bits == jstack.bits
    assert [p.shape for p in tstack.planes] == \
        [tuple(p.shape) for p in jstack.planes]
    assert [tstack.expert_wire_bytes(e, True) for e in range(4)] == \
        [jstack.expert_wire_bytes(e, True) for e in range(4)]
    # quantization error equal up to f32 reduction order; the truncated
    # factors (Gram eigh vs SVD, int8 factors) restore as much
    np.testing.assert_allclose(trep["rel_err_quant"], jrep["rel_err_quant"],
                               rtol=1e-3)
    assert np.all(trep["rel_err_comp"] <= jrep["rel_err_comp"] * 1.01 + 1e-6)
    assert np.all(trep["rel_err_comp"] <= trep["rel_err_quant"] + 1e-7)
    # the port's dense reconstruction is consistent with its own report
    recon = tstack.dequantize_all() + tstack.compensation_all()
    err = torch.linalg.norm((torch.from_numpy(w) - recon).reshape(4, -1),
                            dim=1) / torch.linalg.norm(
        torch.from_numpy(w).reshape(4, -1), dim=1)
    np.testing.assert_allclose(err.numpy(), trep["rel_err_comp"], rtol=1e-4)


def test_heterogeneous_bits_container():
    w = _heavy_tailed(4, 128, 64, seed=5)
    qcfg = QuantConfig(enabled=True, bits=3, group_size=64, rank_budget=8,
                       hqq_iters=2)
    stack, rep = t_compress(torch.from_numpy(w), qcfg,
                            bits=np.array([2, 3, 2, 3]))
    assert stack.bits == 3 and stack.expert_bits == (2, 3, 2, 3)
    codes = tq.unpack_bits(tuple(p[0] for p in stack.planes), 3)
    assert int(codes.max()) <= 3          # 2-bit expert: upper plane zero
    eb, ranks = stack.meta_tensors()
    assert eb.tolist() == [2, 3, 2, 3] and ranks.tolist() == list(stack.ranks)
