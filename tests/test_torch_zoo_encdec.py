"""PyTorch port vs the JAX package on the last of the model zoo at
``reduce_config`` sizes: Whisper-base (an encoder tower over stub frame
embeddings, cross-attention in every decoder layer, sinusoidal absolute
positions, a plain gelu MLP compressed to 3-bit E = 1 stacks) and
Qwen2-VL-7B (M-RoPE over (t, h, w) position streams).

Both sides get the same seeded numpy inputs; JAX's parameters cross
through ``params_from_jax``.  Whisper enters through the step builders
(``launch/steps.py``), as JAX's serving engine passes no encoder input.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import CompressedExpertStack as JStack
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models import ExecContext as JCtx
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import layer_specs as j_layer_specs
from repro.models.transformer import unstack_params as j_unstack
from repro.registry import get_config as j_get_config
from repro_torch.bridge import params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.layers import apply_mrope, sinusoidal_positions
from repro_torch.models.model import forward
from repro_torch.models.transformer import (ExecContext,
                                            compress_dense_params,
                                            init_caches, init_paged_caches,
                                            layer_specs)
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

# f32 on both sides, sums in another order: max |diff| <= REL *
# max |JAX logit|
REL = 1e-5
# through 3-bit E = 1 stacks (the kernels' plain version against JAX's
# ref oracle, both f32): test_torch_model.py's limit
QUANT_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, NEW = 2, 12, 6
_CACHE = {}


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jax_stack(st):
    """The port's ``CompressedExpertStack`` as the JAX package's (the same
    fields and layout; the port's compression writes JAX's format)."""
    arr = {f: jnp.asarray(getattr(st, f).numpy())
           for f in ("scale", "zero", "u", "v", "u_scale", "v_scale")}
    return JStack(planes=tuple(jnp.asarray(p.numpy()) for p in st.planes),
                  bits=st.bits, group_size=st.group_size, shape=st.shape,
                  ranks=st.ranks, pad_rank=st.pad_rank,
                  factor_bits=st.factor_bits, expert_bits=st.expert_bits,
                  **arr)


def _jax_model(arch: str, quantized: bool = False):
    """(JAX cfg, params) of the reduced model, built once per process;
    quantized: every decoder FFN as 3-bit E = 1 stacks at rank budget 16
    (the reduced budget of 8 allocates rank 0 at E = 1), compressed by
    the port (JAX's compression of them would take most of this file's
    time) and handed to JAX in its stack type."""
    key = (arch, quantized)
    if key in _CACHE:
        return _CACHE[key]
    jcfg = j_get_config(arch, reduced=True)
    jp = jax.jit(j_init_params, static_argnums=(1, 2))(
        jax.random.key(5), jcfg, jnp.float32)
    if quantized:
        cfg, params = _port(arch)
        qp, _ = compress_dense_params(
            params, cfg, dataclasses.replace(cfg.quant, rank_budget=16))
        up = j_unstack(jp, jcfg)
        segs = tuple((dict(lp, ffn={"stacks": {
            k: _jax_stack(st) for k, st in qlp["ffn"]["stacks"].items()}}),)
            for (lp,), qlp in zip(up["segments"], qp["layers"]))
        jp = dict(up, segments=segs)
        jcfg = dataclasses.replace(jcfg, force_unroll_plan=True)
    _CACHE[key] = (jcfg, jp)
    return _CACHE[key]


def _port(arch: str, quantized: bool = False):
    jcfg, jp = _jax_model(arch, quantized)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              force_unroll_plan=jcfg.force_unroll_plan)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)


def _frames(cfg, seed=2):
    e = cfg.encoder
    return np.random.default_rng(seed).standard_normal(
        (B, e.source_len, e.d_model)).astype(np.float32)


def mrope_positions(text_a: int, grid, text_b: int) -> np.ndarray:
    """(3, S) Qwen2-VL rope index of ``text_a`` text tokens, a ``grid``
    (h, w) image block, then ``text_b`` text tokens: text has t = h = w;
    the block has t constant and h, w the grid offsets from the next free
    id; text after the block resumes at the largest id + 1."""
    gh, gw = grid
    t = list(range(text_a))
    h, w = list(t), list(t)
    st = text_a
    for r in range(gh):
        for c in range(gw):
            t.append(st)
            h.append(st + r)
            w.append(st + c)
    nxt = max(t + h + w) + 1
    for i in range(text_b):
        t.append(nxt + i)
        h.append(nxt + i)
        w.append(nxt + i)
    return np.asarray([t, h, w], np.int32)


# ---------------------------------------------------------------------------
# plans and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-7b"])
def test_layer_specs_match_jax(arch):
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), j_get_config(arch, reduced)
        assert [tuple(s) for s in layer_specs(cfg)] == \
            [tuple(s) for s in j_layer_specs(jcfg)]
    assert layer_specs(get_config(arch))[0].cross == (arch == "whisper-base")


def test_whisper_refusals():
    """A paged cache with cross-attention raises (JAX's refusal); the
    serving engine takes no encoder inputs and names the step builders."""
    cfg, params = _port("whisper-base")
    with pytest.raises(NotImplementedError, match="cross-attention"):
        init_paged_caches(cfg, 2, 8, 4, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="launch/steps.py"):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        forward(params, torch.as_tensor(_tokens(cfg)), cfg,
                ExecContext(mode="prefill"))


# ---------------------------------------------------------------------------
# Whisper-base
# ---------------------------------------------------------------------------

def test_sinusoidal_table_matches_jax():
    """Whisper's table at the reduced width and the published one, for
    positions below 4096.  The frequencies exp(-i log(1e4) / (dim/2 - 1))
    are f32 exps, which XLA rounds differently from torch in the last
    place for 6 of 64 and 21 of 256 of them; an angle ``pos * freq`` then
    differs by up to ``pos`` ulps of a frequency below 1 (2^-24 each), so
    an entry is held to 1e-6 plus ``pos * 2^-23`` (1e-6 at position 0,
    4.9e-4 at 4095), and the frequencies to one ulp."""
    pos = np.arange(4096, dtype=np.float64)[:, None]
    for dim in (128, 512):
        got = sinusoidal_positions(4096, dim).numpy()
        ref = np.asarray(j_sinusoidal(4096, dim))
        assert np.all(np.abs(got - ref) <= 1e-6 + pos * 2.0 ** -23)
        # the row at position 1 holds sin(freq), ~freq for the small ones
        f_got, f_ref = got[1, :dim // 2], ref[1, :dim // 2]
        assert np.all(np.abs(f_got - f_ref) <= np.spacing(np.abs(f_ref)))
        assert sinusoidal_positions(4096, dim) is sinusoidal_positions(
            4096, dim)          # built once per (length, dim, device)


def test_whisper_forward_matches_jax():
    jcfg, jp = _jax_model("whisper-base")
    cfg, params = _port("whisper-base")
    toks, frames = _tokens(cfg), _frames(cfg)
    ref = j_forward(jp, jnp.asarray(toks), jcfg, JCtx(mode="prefill"),
                    enc_embeds=jnp.asarray(frames)).logits
    got = forward(params, torch.as_tensor(toks), cfg,
                  ExecContext(mode="prefill"),
                  enc_embeds=torch.as_tensor(frames)).logits
    assert _rel(got, ref) <= REL


def _jax_steps(arch, quantized, batch, new_tokens=None, mrope_new=None):
    """JAX's prefill step, then NEW tokens fed one at a time through its
    serve step (``new_tokens``, or its greedy choices): (prefill logits
    and each step's, caches, the tokens fed)."""
    jcfg, jp = _jax_model(arch, quantized)
    pre, _ = j_make_prefill_step(jcfg, quantized=quantized)
    step, _ = j_make_serve_step(jcfg, quantized=quantized)
    caches = j_init_caches(jcfg, B, S + NEW, jnp.float32)
    logits, caches = jax.jit(pre)(jp, caches, jax.tree.map(jnp.asarray,
                                                           batch))
    outs, fed = [np.asarray(logits)], []
    step = jax.jit(step)
    for i in range(NEW):
        tok = (outs[-1].argmax(-1)[:, None].astype(np.int32)
               if new_tokens is None else new_tokens[i])
        fed.append(tok)
        sb = {"tokens": jnp.asarray(tok)}
        if mrope_new is not None:
            sb["mrope_pos"] = jnp.asarray(mrope_new[i])
        lg, caches = step(jp, caches, sb)
        outs.append(np.asarray(lg))
    return outs, caches, fed


def _port_steps(arch, quantized, batch, new_tokens, mrope_new=None):
    cfg, params = _port(arch, quantized)
    pre, _ = make_prefill_step(cfg, quantized=quantized, device="cpu")
    step, _ = make_serve_step(cfg, quantized=quantized, device="cpu")
    caches = init_caches(cfg, B, S + NEW, torch.float32, "cpu")
    logits, caches = pre(params, caches, batch)
    outs = [logits.numpy()]
    for i, tok in enumerate(new_tokens):
        sb = {"tokens": tok}
        if mrope_new is not None:
            sb["mrope_pos"] = mrope_new[i]
        lg, caches = step(params, caches, sb)
        outs.append(lg.numpy())
    return outs, caches


@pytest.mark.parametrize("quantized", [False, True])
def test_whisper_steps_match_jax(quantized):
    """The port's make_prefill_step / make_serve_step against JAX's:
    prefill over the frames, then decode steps fed JAX's greedy tokens,
    the cross-attention caches written at prefill equal to JAX's.
    Quantized: every decoder FFN through 3-bit E = 1 stacks (the kernel
    wrappers' plain versions here, JAX's ref oracle)."""
    cfg, _ = _port("whisper-base", quantized)
    batch = {"tokens": _tokens(cfg), "enc_embeds": _frames(cfg)}
    # JAX's greedy continuation, fed to both sides
    jout, jcaches, toks = _jax_steps("whisper-base", quantized, batch)
    pout, pcaches = _port_steps("whisper-base", quantized, batch, toks)
    for got, ref in zip(pout, jout):
        if quantized:
            np.testing.assert_allclose(got, ref, **QUANT_TOL)
        else:
            assert _rel(got, ref) <= REL
    # JAX's caches of a scanned segment carry a leading repeat axis
    jl = []
    for seg in jcaches["segments"]:
        for c in seg:
            if c["cross_k"].ndim == 4:
                jl.append(c)
            else:
                jl += [{k: v[r] for k, v in c.items()}
                       for r in range(c["cross_k"].shape[0])]
    assert len(jl) == len(pcaches["layers"])
    for pc, jc in zip(pcaches["layers"], jl):
        for name in ("cross_k", "cross_v"):
            np.testing.assert_allclose(pc[name].numpy(),
                                       np.asarray(jc[name]), rtol=1e-5,
                                       atol=1e-5)
    assert pcaches["pos"].tolist() == [S + NEW] * B


# ---------------------------------------------------------------------------
# Qwen2-VL-7B
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [128, 32])
def test_apply_mrope_matches_jax(hd):
    """At the published head dim (sections t 16, h 24, w 24 of the 64
    frequency slots) and at the reduced one (16 slots: all in t)."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 20, 4, hd)).astype(np.float32)
    pos3 = np.stack([mrope_positions(4, (3, 4), 4)] * B, axis=1)
    got = apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6)
    ref = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_qwen2_vl_forward_with_grid_matches_jax():
    """A grid block between two text runs, positions by Qwen2-VL's rope
    index rule; and ``mrope_pos=None`` is 1-D RoPE, bit for bit the
    t = h = w positions."""
    jcfg, jp = _jax_model("qwen2-vl-7b")
    cfg, params = _port("qwen2-vl-7b")
    toks = _tokens(cfg)
    pos3 = np.stack([mrope_positions(3, (2, 3), 3)] * B, axis=1)
    ref = j_forward(jp, jnp.asarray(toks), jcfg, JCtx(mode="prefill"),
                    mrope_pos=jnp.asarray(pos3)).logits
    ctx = ExecContext(mode="prefill")
    got = forward(params, torch.as_tensor(toks), cfg, ctx,
                  mrope_pos=torch.as_tensor(pos3)).logits
    assert _rel(got, ref) <= REL
    flat = torch.arange(S, dtype=torch.int32).expand(3, B, S)
    text = forward(params, torch.as_tensor(toks), cfg, ctx).logits
    assert torch.equal(text, forward(params, torch.as_tensor(toks), cfg,
                                     ctx, mrope_pos=flat).logits)
    assert _rel(text, j_forward(jp, jnp.asarray(toks), jcfg,
                                JCtx(mode="prefill")).logits) <= REL


def test_qwen2_vl_steps_match_jax():
    """Prefill with a grid block, then decode steps at (3, B, 1)
    positions resuming past the block's largest id."""
    cfg, _ = _port("qwen2-vl-7b")
    pos3 = np.stack([mrope_positions(3, (2, 3), 3)] * B, axis=1)
    batch = {"tokens": _tokens(cfg), "mrope_pos": pos3}
    nxt = int(pos3.max()) + 1
    toks = [np.full((B, 1), 7 + i, np.int32) for i in range(NEW)]
    mnew = [np.full((3, B, 1), nxt + i, np.int32) for i in range(NEW)]
    jout, _, _ = _jax_steps("qwen2-vl-7b", False, batch, toks, mnew)
    pout, _ = _port_steps("qwen2-vl-7b", False, batch, toks, mnew)
    for got, ref in zip(pout, jout):
        assert _rel(got, ref) <= REL
