"""PyTorch port vs the JAX package on training: ``lm_loss`` values and
gradients (``jax.value_and_grad`` against autograd), the fused and the
plain cross entropy, AdamW and its schedule, gradient accumulation, the
fault-tolerant loop (histories against JAX's ``train``; checkpoint
round trip, keep-k, torn writes, kill and resume, stragglers), sequence
packing and the train CLI, at reduced sizes on the CPU.

Both sides start from the same parameters (JAX's, bridged) and the same
seeded numpy batches.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data.packing import pack_documents as j_pack_documents
from repro.data.packing import segment_attention_bias as j_segment_bias
from repro.models import ExecContext as JCtx
from repro.models import lm_loss as j_lm_loss
from repro.models.transformer import init_params as j_init_params
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.adamw import warmup_cosine as j_warmup_cosine
from repro.registry import get_config as j_get_config
from repro.train import train as j_train
from repro.train.microbatch import microbatched_value_and_grad as j_micro
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.packing import (pack_documents, packing_efficiency,
                                      segment_attention_bias)
from repro_torch.launch.steps import make_context, make_train_step
from repro_torch.models.model import lm_loss
from repro_torch.models.transformer import ExecContext, init_params
from repro_torch.optim.adamw import adamw_update, warmup_cosine
from repro_torch.registry import get_config
from repro_torch.train import FailureInjector, StragglerMonitor, train
from repro_torch.train.microbatch import (microbatched_value_and_grad,
                                          value_and_grad)
from repro_torch.tree import tree_leaves, tree_map

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

# loss values, f32 on both sides (sums in another order)
VALUE_REL = 1e-5
# gradients, f32 both sides (plain xent): max |diff| <= GRAD_REL * max |g|
GRAD_REL = 1e-4
# bf16 cotangents (the fused xent): tests/test_fused_xent.py's limit
BF16_REL = 2e-2
_CACHE = {}


def _tiny(tie=True, cls=ModelConfig):
    return cls(name="t", family="dense", num_layers=2, d_model=64,
               num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
               vocab_size=256, block_pattern=("global",),
               tie_embeddings=tie, max_position=256)


def _model(name: str):
    """(JAX cfg, JAX params, port cfg, port params) per process."""
    if name not in _CACHE:
        if name.startswith("tiny"):
            tie = name == "tiny_tied"
            jcfg, cfg = _tiny(tie, JModelConfig), _tiny(tie)
        else:
            jcfg, cfg = j_get_config(name, True), get_config(name, True)
        jp = jax.jit(j_init_params, static_argnums=(1, 2))(
            jax.random.key(0), jcfg, jnp.float32)
        _CACHE[name] = (jcfg, jp, cfg,
                        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return _CACHE[name]


def _batch(cfg, b=2, s=34, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32),
             "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}
    if cfg.encoder is not None:
        e = cfg.encoder
        batch["enc_embeds"] = rng.standard_normal(
            (b, e.source_len, e.d_model)).astype(np.float32)
    if cfg.rope_kind == "mrope":
        pos = np.arange(s, dtype=np.int32)
        pos3 = np.stack([pos, pos, pos])
        pos3[1:, 4:10] += np.arange(6, dtype=np.int32) % 3  # a 2 x 3 block
        batch["mrope_pos"] = np.stack([pos3] * b, axis=1)
    return batch


def _xent(mode):
    class _Env:
        def __enter__(self):
            os.environ["REPRO_XENT"] = mode

        def __exit__(self, *a):
            os.environ.pop("REPRO_XENT", None)
    return _Env()


def _port_vg(name, batch, chunk, mode, model=None):
    cfg, params = model or _model(name)[2:]
    ctx = ExecContext(mode="train")
    with _xent(mode):
        (loss, metrics), grads = value_and_grad(
            lambda p, b: lm_loss(p, b, cfg, ctx, loss_chunk=chunk))(
                params, {k: torch.as_tensor(v) for k, v in batch.items()})
    return loss, metrics, grads


def _jax_vg(name, batch, chunk, mode):
    jcfg, jp, _, _ = _model(name)
    jb = jax.tree.map(jnp.asarray, batch)
    with _xent(mode):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: j_lm_loss(p, jb, jcfg, JCtx(mode="train"),
                                loss_chunk=chunk), has_aux=True))(jp)
    return loss, metrics, params_from_jax(jax.tree.map(np.asarray, grads),
                                          "cpu")


def _grad_err(a, b) -> float:
    return max(float((x - y).abs().max()) / (float(y.abs().max()) + 1e-6)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# model, loss chunk (16 with S 34: 33 targets padded to 48), xent mode:
# tied embeddings (tiny, Whisper) and untied (DeepSeek-MoE, Qwen2-VL),
# chunked and not, plain and fused; the port's plain against its fused
# path, tied and untied, in test_fused_xent_matches_plain
LOSS_CASES = [("tiny_tied", 16, "plain"), ("deepseek-moe-16b", 16, "plain"),
              ("whisper-base", 0, "fused"), ("qwen2-vl-7b", 16, "fused")]


@pytest.mark.parametrize("name,chunk,mode", LOSS_CASES)
def test_lm_loss_and_grads_match_jax(name, chunk, mode):
    """Value (and each metric: loss, z-loss, the MoE aux losses, total)
    within VALUE_REL, gradients within GRAD_REL of max |g| per leaf on the
    plain path and BF16_REL on the fused one (bf16 cotangents on both
    sides, rounded by two frameworks)."""
    _, _, cfg, _ = _model(name)
    batch = _batch(cfg)
    loss, metrics, grads = _port_vg(name, batch, chunk, mode)
    jloss, jmetrics, jgrads = _jax_vg(name, batch, chunk, mode)
    assert list(metrics) == ["loss", "z_loss", "load_balance", "router_z",
                             "total_loss"]
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= \
            VALUE_REL * max(abs(float(v)), 1e-3), k
    if cfg.moe is not None:
        assert float(metrics["load_balance"]) > 0
    assert _grad_err(grads, jgrads) <= (GRAD_REL if mode == "plain"
                                        else BF16_REL)


@pytest.mark.parametrize("tie", [True, False])
def test_fused_xent_matches_plain(tie):
    """The port's counterpart of tests/test_fused_xent.py: values within
    1e-4, gradients within 2e-2 of max |g|."""
    cfg = _tiny(tie)
    model = (cfg, init_params(cfg, 0, torch.float32, "cpu"))
    batch = _batch(cfg, s=33)
    vp, _, gp = _port_vg(None, batch, 16, "plain", model)
    vf, _, gf = _port_vg(None, batch, 16, "fused", model)
    assert abs(float(vp) - float(vf)) < 1e-4
    assert _grad_err(gf, gp) < BF16_REL


# ---------------------------------------------------------------------------
# AdamW, accumulation
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_jax():
    tcfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    jcfg = JTrainConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    for s in (0, 1, 9, 10, 11, 30, 49, 50, 60):
        got = float(warmup_cosine(tcfg, torch.tensor(s, dtype=torch.int32)))
        ref = float(j_warmup_cosine(jcfg, jnp.asarray(s, jnp.int32)))
        assert abs(got - ref) <= 1e-7 * max(ref, 1e-6), s
    assert float(warmup_cosine(tcfg, torch.tensor(60))) == \
        pytest.approx(1e-3 * 0.02)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    """Three updates from one bridged state, clipping on (norms above 1)
    and off: master, m, v, the compute params, grad norm and lr."""
    jcfg, jp, cfg, params = _model("tiny_tied")
    tk = dict(lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=clip)
    tcfg, jtcfg = TrainConfig(**tk), JTrainConfig(**tk)
    jstate = j_adamw_init(jp)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    params = tree_map(torch.clone, params)    # updated in place
    rng = np.random.default_rng(3)
    for _ in range(3):
        jg = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jp)
        g = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
        jp, jstate, jm = jax.jit(j_adamw_update, static_argnums=(2, 3))(
            jg, jstate, jtcfg, jnp.float32)
        params, state, m = adamw_update(g, state, tcfg, params)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == 3
    ref = opt_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for got, want in ((state.master, ref.master), (state.m, ref.m),
                      (state.v, ref.v),
                      (params, params_from_jax(jax.tree.map(np.asarray, jp),
                                               "cpu"))):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_microbatched_grads_match_full_batch_and_jax():
    w = {"w": np.asarray([2.0, -1.0, 0.5], np.float32)}
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        loss = torch.mean(pred ** 2)
        return loss, {"loss": loss}

    def j_loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        loss = jnp.mean(pred ** 2)
        return loss, {"loss": loss}

    tw = {"w": torch.as_tensor(w["w"])}
    full = value_and_grad(loss_fn)(tw, {"x": torch.as_tensor(x)})
    micro = microbatched_value_and_grad(loss_fn, 4)(
        tw, {"x": torch.as_tensor(x)})
    jm = j_micro(j_loss_fn, 4)({"w": jnp.asarray(w["w"])},
                               {"x": jnp.asarray(x)})
    assert float(micro[0][0]) == pytest.approx(float(full[0][0]), rel=1e-6)
    assert float(micro[0][1]["loss"]) == pytest.approx(float(jm[0][1]["loss"]),
                                                       rel=1e-6)
    np.testing.assert_allclose(micro[1]["w"].numpy(), full[1]["w"].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(micro[1]["w"].numpy(), np.asarray(jm[1]["w"]),
                               rtol=1e-6)
    assert not tw["w"].requires_grad      # the caller's tensors unmarked


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_train_history_matches_jax():
    """Six steps of the tiny model from JAX's initial parameters (through
    ``init_fn``) on the same synthetic batches: loss, grad norm and lr per
    step."""
    jcfg, jp, cfg, _ = _model("tiny_tied")
    tk = dict(total_steps=6, lr=1e-3, warmup_steps=2, loss_chunk=16)
    # a copy: JAX's loop donates the state it is given
    ref = j_train(jcfg, JTrainConfig(**tk), log_every=0,
                  batch_shape=(2, 32),
                  init_fn=lambda key: jax.tree.map(jnp.copy, jp))
    res = train(cfg, TrainConfig(**tk), log_every=0, batch_shape=(2, 32),
                init_fn=lambda seed: params_from_jax(
                    jax.tree.map(np.asarray, jp), "cpu"), device="cpu")
    assert [h["step"] for h in res.history] == list(range(6))
    for h, r in zip(res.history, ref.history):
        assert h["loss"] == pytest.approx(r["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-4)
        assert h["lr"] == pytest.approx(r["lr"], rel=1e-6)


def test_checkpoint_roundtrip_keep_k_and_torn_write(tmp_path):
    """The port's counterparts of test_fault_tolerance.py's roundtrip,
    keep-k and torn-write tests, on a tree with a named tuple."""
    from repro_torch.optim.adamw import OptState
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)},
            "opt": OptState(torch.tensor(3, dtype=torch.int32),
                            [torch.ones(2)], [torch.zeros(2)],
                            [torch.full((2,), 2.0, dtype=torch.bfloat16)])}
    mgr.save(10, tree)
    tmpl = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.int32)},
            "opt": OptState(torch.tensor(0, dtype=torch.int32),
                            [torch.zeros(2)], [torch.zeros(2)],
                            [torch.zeros(2, dtype=torch.bfloat16)])}
    restored, man = mgr.restore(tmpl)
    assert man["step"] == 10 and isinstance(restored["opt"], OptState)
    for x, y in zip(tree_leaves(restored), tree_leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({**tmpl, "a": torch.zeros(3, 2)}, step=10)
    with pytest.raises(NotImplementedError, match="A13"):
        mgr.restore(tmpl, shardings={})
    for s in (11, 12, 13):
        mgr.save(s, tree)
    assert mgr.all_steps() == [12, 13]
    t2 = {"x": torch.arange(4.0)}
    mgr2 = CheckpointManager(tmp_path / "torn", keep=3)
    mgr2.save(1, t2)
    mgr2.save(2, {"x": t2["x"] + 1})
    # corrupt the newest checkpoint data (manifest committed, data torn)
    (mgr2.dir / "step_00000002.npz").write_bytes(b"garbage")
    restored, man = mgr2.restore({"x": torch.zeros(4)})
    assert man["step"] == 1 and torch.equal(restored["x"], t2["x"])


def test_failure_injection_and_resume_is_exact(tmp_path):
    """Kill training mid-run, restart from the checkpoint directory: the
    resumed steps repeat the uninterrupted run's history bit for bit."""
    cfg = _tiny()
    tcfg = TrainConfig(total_steps=9, checkpoint_every=3, lr=1e-3,
                       warmup_steps=2, loss_chunk=0)
    ref = train(cfg, tcfg, log_every=0, batch_shape=(2, 32), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, tcfg, checkpoint_dir=str(tmp_path), log_every=0,
              failure=FailureInjector(fail_at_step=7), batch_shape=(2, 32),
              device="cpu")
    res = train(cfg, tcfg, checkpoint_dir=str(tmp_path), log_every=0,
                batch_shape=(2, 32), device="cpu")
    assert res.resumed_from == 6
    assert [h["step"] for h in res.history] == [6, 7, 8]
    for h, r in zip(res.history, ref.history[6:]):
        assert (h["loss"], h["grad_norm"]) == (r["loss"], r["grad_norm"])
    for a, b in zip(tree_leaves(res.state), tree_leaves(ref.state)):
        assert torch.equal(a, b)


def test_straggler_monitor_flags_and_aborts():
    mon = StragglerMonitor(threshold=2.0, warmup=2, policy="warn")
    for s in range(5):
        mon.observe(s, 0.10)
    assert mon.observe(5, 0.50)          # 5x the EWMA -> flagged
    assert mon.flagged == [5]
    mon2 = StragglerMonitor(threshold=2.0, warmup=1, policy="abort")
    mon2.observe(0, 0.1)
    mon2.observe(1, 0.1)
    with pytest.raises(TimeoutError):
        mon2.observe(2, 10.0)


def test_refusals_and_device(monkeypatch):
    """A mesh waits for A13 and the 'dots' remat policy for A15; without
    a card the trainer and the step builders raise unless the CPU is
    asked for."""
    cfg = _tiny()
    with pytest.raises(NotImplementedError, match="A13"):
        make_context(cfg, "train", mesh=object())
    step, _ = make_train_step(cfg, TrainConfig(), remat_policy="dots",
                              device="cpu")
    params = _model("tiny_tied")[3]
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import adamw_init
    with pytest.raises(NotImplementedError, match="A15"):
        step(TrainState(params, adamw_init(params)), _batch(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, TrainConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, TrainConfig())


# ---------------------------------------------------------------------------
# packing, the CLI
# ---------------------------------------------------------------------------

def test_packing_matches_jax():
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 100, (int(n),)) for n in (5, 3, 9, 17, 1, 8)]
    for seq_len in (8, 16):
        got, ref = pack_documents(docs, seq_len), j_pack_documents(docs,
                                                                  seq_len)
        assert got.keys() == ref.keys()
        for k in got:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(
            segment_attention_bias(got["segment_ids"]),
            j_segment_bias(ref["segment_ids"]))
    assert packing_efficiency(pack_documents(docs, 8)) == pytest.approx(
        43 / 48)


def test_train_cli_runs_two_steps(tmp_path, capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", "deepseek-moe-16b", "--steps", "2", "--batch",
                "2", "--seq", "16", "--ckpt", str(tmp_path), "--device",
                "cpu"])
    assert [h["step"] for h in res.history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert CheckpointManager(tmp_path).latest_step() == 2
    assert "done; final loss" in capsys.readouterr().out
