"""PyTorch port vs the JAX package: greedy ``ServeEngine.generate`` on
reduced Mixtral-8x7B with JAX-compressed experts is token-identical, and
its router trace and log-probs agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params as j_compress
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import bucket_len as j_bucket_len
from repro_torch.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, bucket_len

_CACHE = {}


def _jax_engine_run(prompts, max_new):
    if "run" not in _CACHE:
        jcfg = j_get_config("mixtral-8x7b", reduced=True)
        jp = j_init_params(jax.random.key(3), jcfg, jnp.float32)
        jq, jcfg_q, _ = j_compress(jp, jcfg)
        res = JServeEngine(jcfg_q, jq, quantized=True,
                           kernel_impl="ref").generate(prompts, max_new)
        _CACHE.update(run=res, jq=jq, jcfg_q=jcfg_q)
    return _CACHE


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_greedy_generate_token_identical(impl):
    import dataclasses
    from repro_torch.registry import get_config
    prompts = np.random.default_rng(5).integers(2, 512, (2, 11)) \
        .astype(np.int32)
    m = _jax_engine_run(prompts, 8)
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                              force_unroll_plan=True)
    params = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    res = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu").generate(prompts, 8)
    want = m["run"]
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_array_equal(res.router_trace, want.router_trace)
    np.testing.assert_allclose(res.logprobs, want.logprobs, rtol=1e-4,
                               atol=1e-4)
    assert res.steps == 8 and res.decode_tokens_per_s > 0


@pytest.mark.parametrize("n", [1, 16, 17, 33, 300])
def test_bucket_len_matches_jax(n):
    assert bucket_len(n) == j_bucket_len(n)
    assert bucket_len(n, 16) == j_bucket_len(n, 16)
