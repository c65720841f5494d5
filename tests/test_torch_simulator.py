"""The port's offload projections against the JAX package's, on the CPU:
the paper's hardware profiles (``offload/bandwidth.py``), the synthetic
router trace and the event-driven decode simulator
(``offload/simulator.py``) under every policy, with and without the
layer-ahead prefetch and with the bandwidth controller in the loop, and
``serve.engine.router_trace`` on the tiny MoE of
``tests/test_serve_scheduler.py`` (JAX-compressed stacks carried into the
port by ``bridge.py``).  Every ``SimResult`` field must be equal: both
sides run the same float64 host arithmetic on the same trace."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ControlConfig as JControlConfig
from repro.models import init_params as j_init_params
from repro.offload import bandwidth as j_bw
from repro.offload import simulator as j_sim
from repro.serve.engine import router_trace as j_router_trace
from repro_torch import offload as t_offload
from repro_torch.bridge import params_from_jax
from repro_torch.config import ControlConfig
from repro_torch.offload import bandwidth as t_bw
from repro_torch.offload import simulator as t_sim
from repro_torch.serve import router_trace

from test_serve_scheduler import compress, moe_cfg
from test_torch_serve import port_moe_cfg
import torch_cpu  # noqa: F401  (one intra-op thread per worker)

POLICIES = ("fp16", "quant", "ours", "ours_adaptive", "fp16_ndp",
            "quant_ndp", "ours_ndp", "ours_adaptive_ndp")


def test_profiles_match_jax():
    """The paper's two H100 deployments, field for field; the TPU
    profile is left out of the port."""
    assert set(t_bw.PROFILES) == set(j_bw.PROFILES) - {"tpu-v5e-offload"}
    for name, prof in t_bw.PROFILES.items():
        assert dataclasses.asdict(prof) == \
            dataclasses.asdict(j_bw.PROFILES[name])
        for nbytes in (0, 4096, 3.2e6):
            assert prof.transfer_time(nbytes) == \
                j_bw.PROFILES[name].transfer_time(nbytes)
            assert prof.hbm_time(nbytes) == j_bw.PROFILES[name].hbm_time(
                nbytes)
            assert prof.ndp_compute_time(1e9, nbytes) == \
                j_bw.PROFILES[name].ndp_compute_time(1e9, nbytes)
        assert prof.compute_time(1e12) == \
            j_bw.PROFILES[name].compute_time(1e12)
    assert t_offload.GPU_ONLY == t_bw.GPU_ONLY
    assert t_offload.simulate_decode is t_sim.simulate_decode


@pytest.mark.parametrize("skew", [0.0, 0.6])
def test_make_router_trace_matches_jax(skew):
    args = (None, 40, 6, 2)
    kw = dict(seed=3, skew=skew, num_experts=8)
    a = j_sim.make_router_trace(*args, **kw)
    b = t_sim.make_router_trace(*args, **kw)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _spec(mod, ranks=True):
    rng = np.random.default_rng(0)
    comp = [int(x) for x in rng.integers(0, 40000, 8)]
    return mod.LayerSpecSim(
        d_model=4096, d_expert=14336, num_experts=8, top_k=2,
        bytes_fp16=3 * 4096 * 14336 * 2, bytes_quant=3 * 4096 * 14336 // 4,
        comp_bytes=comp,
        ranks=[int(x) for x in rng.integers(0, 64, 8)] if ranks else None)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_decode_matches_jax(policy, prefetch):
    """Every ``SimResult`` field equal on one synthetic trace, at both
    hardware profiles (an ``_ndp`` policy at GPU-NDP only: GPU-only has
    no near-data device), the adaptive policy under a budget, its
    controller retuning every 4 tokens."""
    trace = j_sim.make_router_trace(None, 48, 6, 2, seed=1, skew=0.4,
                                    num_experts=8)
    names = [t_bw.GPU_NDP.name] if policy.endswith("_ndp") else \
        list(t_bw.PROFILES)
    for name in names:
        kw = dict(top_n=1, cache_capacity=3, num_layers=6,
                  prefetch=prefetch)
        got = {}
        for mod, bw, cc in ((j_sim, j_bw, JControlConfig),
                            (t_sim, t_bw, ControlConfig)):
            control = (cc(enabled=True, bytes_per_token=2.2e8)
                       if "adaptive" in policy else None)
            got[mod] = mod.simulate_decode(trace, _spec(mod),
                                           bw.PROFILES[name], policy,
                                           control=control, **kw)
        assert dataclasses.asdict(got[t_sim]) == \
            dataclasses.asdict(got[j_sim]), (policy, name)
        assert got[t_sim].tokens_per_s > 0
    if "adaptive" in policy:
        assert 0 < got[t_sim].mean_rank_cap


def test_simulate_decode_raises_like_jax():
    trace = t_sim.make_router_trace(None, 8, 2, 2, seed=0)
    for mod, bw in ((j_sim, j_bw), (t_sim, t_bw)):
        with pytest.raises(ValueError, match="ControlConfig"):
            mod.simulate_decode(trace, _spec(mod), bw.GPU_ONLY,
                                "ours_adaptive")
        with pytest.raises(ValueError, match="ranks"):
            mod.simulate_decode(
                trace, _spec(mod, ranks=False), bw.GPU_ONLY, "ours_adaptive",
                control=(JControlConfig if mod is j_sim
                         else ControlConfig)(enabled=True))
    assert t_sim.expert_flops(_spec(t_sim)) == j_sim.expert_flops(
        _spec(j_sim))


def test_router_trace_matches_jax():
    """(tokens, moe_layers, k) routed ids of one exact-capacity forward
    over a (3, 20) batch of the compressed model: equal to JAX's
    (the f32 router of the tiny MoE has no near-tie here), and the
    simulator replays it to equal results on both sides."""
    params = j_init_params(jax.random.key(4), moe_cfg(), jnp.float32)
    cfg_q, qparams, _ = compress(moe_cfg(), params)
    tq = params_from_jax(jax.tree.map(np.asarray, qparams), "cpu")
    tokens = np.random.default_rng(5).integers(0, 128, (3, 20),
                                               dtype=np.int32)
    a = j_router_trace(cfg_q, qparams, tokens, quantized=True)
    b = router_trace(port_moe_cfg(), tq, tokens, quantized=True)
    assert b.shape == (60, 2, 2) and b.dtype == a.dtype
    np.testing.assert_array_equal(a, b)
    res = [mod.simulate_decode(tr, _spec(mod), bw.GPU_NDP, "ours_ndp",
                               num_layers=2, cache_capacity=2)
           for mod, bw, tr in ((j_sim, j_bw, a), (t_sim, t_bw, b))]
    assert dataclasses.asdict(res[0]) == dataclasses.asdict(res[1])
    assert isinstance(b, np.ndarray) and not torch.is_tensor(b)
