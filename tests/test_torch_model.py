"""PyTorch port vs the JAX package on reduced Mixtral-8x7B: prefill and
decode-step logits and router traces, for dense experts and for
JAX-compressed quantized experts; plus the port's package rules (no JAX
imports, CUDA by default)."""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ExecContext as JCtx
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params as j_compress
from repro.registry import get_config as j_get_config
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import decode_step, forward
from repro_torch.models.transformer import (ExecContext, init_caches,
                                            init_params)
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
# f32 on both sides; sums run in another order (einsum paths, the
# factored dequant of the kernel's plain version)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _models():
    """(jax cfg, jax params, jax qparams, jax cfg_q) on reduced mixtral,
    built once per test process."""
    if not _CACHE:
        jcfg = j_get_config("mixtral-8x7b", reduced=True)
        jp = j_init_params(jax.random.key(0), jcfg, jnp.float32)
        jq, jcfg_q, _ = j_compress(jp, jcfg)
        _CACHE.update(jcfg=jcfg, jp=jp, jq=jq, jcfg_q=jcfg_q)
    return _CACHE


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama3.2-3b",
                                  "deepseek-moe-16b", "qwen3-moe-30b-a3b",
                                  "gemma3-1b", "gemma3-27b", "qwen2-7b",
                                  "mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_config_copy_matches_jax(arch):
    for reduced in (True, False):
        _check_config_copy(j_get_config(arch, reduced=reduced),
                           get_config(arch, reduced=reduced))


def _check_config_copy(jcfg, tcfg):
    for f in dataclasses.fields(tcfg):
        tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "moe" and tv is not None:
            for g in dataclasses.fields(tv):
                a, b = getattr(tv, g.name), getattr(jv, g.name)
                if g.name == "quant":
                    assert dataclasses.asdict(a).items() <= \
                        dataclasses.asdict(b).items()
                else:
                    assert a == b, g.name
        elif f.name == "quant":
            assert dataclasses.asdict(tv).items() <= \
                dataclasses.asdict(jv).items()
        else:
            assert tv == jv, f.name


def test_serve_and_control_config_copies_match_jax():
    """``ControlConfig`` is a copy without ``budget_scope`` (it budgets
    expert-parallel serving, not ported); ``StreamConfig`` and
    ``SpecConfig`` are copies (fields, defaults, asserts); ``ServeConfig``
    keeps a subset of the JAX fields, each with the JAX default
    (``control``, ``stream`` and ``spec`` included)."""
    from repro.config import ControlConfig as JControlConfig
    from repro.config import ServeConfig as JServeConfig
    from repro.config import SpecConfig as JSpecConfig
    from repro.config import StreamConfig as JStreamConfig
    from repro_torch.config import (ControlConfig, ServeConfig, SpecConfig,
                                    StreamConfig)
    for port_cls, jax_cls, bads in (
            (StreamConfig, JStreamConfig,
             (dict(miss_policy="drop"), dict(ring_slots=0))),
            (SpecConfig, JSpecConfig,
             (dict(k=-1), dict(drafter="oracle"), dict(ngram_order=1),
              dict(draft_window=0)))):
        assert [(f.name, f.default) for f in dataclasses.fields(port_cls)] \
            == [(f.name, f.default) for f in dataclasses.fields(jax_cls)]
        for bad in bads:
            with pytest.raises(AssertionError):
                jax_cls(**bad)
            with pytest.raises(AssertionError):
                port_cls(**bad)
    assert [f.name for f in dataclasses.fields(ControlConfig)] == \
        [f.name for f in dataclasses.fields(JControlConfig)
         if f.name != "budget_scope"]
    jdefaults = dataclasses.asdict(JControlConfig())
    assert jdefaults.pop("budget_scope") == "aggregate"
    assert dataclasses.asdict(ControlConfig()) == jdefaults
    cc = dict(enabled=True, bytes_per_token=0.0, tokens_per_s=2e3)
    assert ControlConfig(**cc).target_bytes_per_token == \
        JControlConfig(**cc).target_bytes_per_token
    kept = {f.name for f in dataclasses.fields(ServeConfig)}
    assert kept == {"temperature", "eos_id", "cache_experts", "num_slots",
                    "chunk_steps", "page_size", "prefix_cache", "control",
                    "stream", "spec"}
    port, jax_ = dataclasses.asdict(ServeConfig()), \
        dataclasses.asdict(JServeConfig())
    jax_["control"].pop("budget_scope")
    assert port.items() <= jax_.items()


def _run_both(quantized: bool, impl: str, kv_bits: int = 16):
    m = _models()
    jcfg = dataclasses.replace(m["jcfg_q"] if quantized else m["jcfg"],
                               kv_bits=kv_bits)
    jparams = m["jq"] if quantized else m["jp"]
    tcfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                               force_unroll_plan=quantized, kv_bits=kv_bits)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)

    jc = j_init_caches(jcfg, 2, 16, jnp.float32)
    kw = dict(quantized=quantized, exact_capacity=True, collect_trace=True)
    jpre = j_forward(jparams, jnp.asarray(toks[:, :8]), jcfg,
                     JCtx(mode="prefill", kernel_impl="ref", **kw),
                     caches=jc)
    jstep = j_decode_step(jparams, jnp.asarray(toks[:, 8:]), jpre.caches,
                          jcfg, JCtx(mode="step", kernel_impl="ref", **kw))

    tc = init_caches(tcfg, 2, 16, torch.float32, device="cpu")
    tpre = forward(tparams, torch.from_numpy(toks[:, :8]), tcfg,
                   ExecContext(mode="prefill", kernel_impl=impl, **kw),
                   caches=tc)
    tstep = decode_step(tparams, torch.from_numpy(toks[:, 8:]), tpre.caches,
                        tcfg, ExecContext(mode="step", kernel_impl=impl,
                                          **kw))
    for j, t in ((jpre, tpre), (jstep, tstep)):
        np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(t.trace.numpy(), np.asarray(j.trace))
    np.testing.assert_array_equal(tstep.caches["pos"].numpy(),
                                  np.asarray(jstep.caches["pos"]))


def test_dense_forward_and_decode_match_jax():
    _run_both(quantized=False, impl="auto")


@pytest.mark.parametrize("impl,kv_bits", [("auto", 16), ("ref", 16),
                                           ("auto", 8)])
def test_quantized_forward_and_decode_match_jax(impl, kv_bits):
    _run_both(quantized=True, impl=impl, kv_bits=kv_bits)


def test_port_compression_serves_like_jax_compression():
    """The port's own compression of the same dense weights serves
    logits close to the JAX-compressed model's (quantization is the same
    up to float order; compensators may differ in sign only)."""
    from repro_torch.models.transformer import compress_moe_params
    m = _models()
    tcfg = get_config("mixtral-8x7b", reduced=True)
    tp = params_from_jax(jax.tree.map(np.asarray, m["jp"]), "cpu")
    tq_own, tcfg_q, _ = compress_moe_params(tp, tcfg)
    tq_jax = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32))
    ctx = ExecContext(mode="train", quantized=True, exact_capacity=True)
    a = forward(tq_own, toks, tcfg_q, ctx).logits
    b = forward(tq_jax, toks, tcfg_q, ctx).logits
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) < 0.02 * scale


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("serve/scheduler.py", "serve/controller.py",
                "offload/__init__.py", "offload/store.py",
                "offload/prefetch.py", "offload/cache.py",
                "data/synthetic.py", "calib/stats.py", "calib/allocate.py",
                "calib/artifact.py", "checkpoint/artifact.py",
                "launch/compress.py", "launch/serve.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax",
                               "ml_dtypes"), \
                f"{f.relative_to(ROOT)} imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mixtral-8x7b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    from repro_torch.bridge import to_torch
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch(np.zeros(3))
