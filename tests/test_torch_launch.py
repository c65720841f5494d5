"""The port's two CLIs on the CPU (``--device cpu``), on reduced
Mixtral-8x7B: ``repro_torch.launch.compress`` (calibrate → allocate →
compress → artifact) and ``repro_torch.launch.serve --offload --artifact``
booting that artifact.  Serving from the artifact must give the tokens,
router trace, offload report and per-request bytes of serving the
stacks ``compress.run`` returned in memory;
the stream flags serve with every metered byte copied; ``--page-size``
(with ``--prefix-cache``) serves the same tokens on a paged cache;
``--spec-k`` / ``--drafter`` serve the same greedy tokens speculatively.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import compress, serve
from repro_torch.models.transformer import (apply_compressed_stacks,
                                            init_params)
from repro_torch.registry import get_config
from repro_torch.serve import ServeEngine, synthetic_workload

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

ARCH = "mixtral-8x7b"
SERVE = ["--arch", ARCH, "--device", "cpu", "--offload", "--requests", "6",
         "--slots", "2", "--chunk", "4", "--max-new", "6",
         "--prompt-len", "20", "--cache-experts", "3", "--seed", "1"]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    out = tmp_path_factory.mktemp("art")
    res = compress.main(["--arch", ARCH, "--out", str(out), "--device",
                         "cpu", "--budget-frac", "0.9", "--seed", "1",
                         "--calib-batches", "2", "--calib-batch-size", "4",
                         "--calib-seq-len", "64"])
    return out, res


def test_compress_cli_writes_the_plan_and_stacks(art, capsys):
    out, res = art
    man = json.loads((out / "artifact.json").read_text())
    meta = man["meta"]
    assert meta["seed"] == 1 and meta["moe_layers"] == 2
    assert meta["extra"]["params_init"] == "repro_torch"
    assert meta["extra"]["whitened"] is True
    assert meta["plan"] == res["plan"].to_json()
    assert meta["plan"]["spent_bytes"] <= meta["plan"]["budget_bytes"]
    assert meta["extra"]["wire_bytes"] == res["wire_bytes"] \
        == meta["plan"]["spent_bytes"]
    assert set(res["seconds"]) == {"init", "calibrate", "allocate",
                                   "compress", "artifact"}
    assert man["checksum"] == res["manifest"]["checksum"]


def _in_memory_engine(res, seed=1):
    cfg = get_config(ARCH, reduced=True)
    params = init_params(cfg, seed, torch.float32, "cpu")
    qparams, cfg_q = apply_compressed_stacks(params, cfg,
                                             res["stacks_by_layer"])
    eng = ServeEngine(cfg_q, qparams, quantized=True, device="cpu")
    eng.attach_offload(res["stacks_by_layer"], policy="ours",
                       cache_capacity=3)
    reqs = synthetic_workload(6, cfg.vocab_size, max_new=6, min_len=10,
                              max_len=20, seed=seed)
    return eng.serve(reqs, num_slots=2, chunk=4, seed=seed)


def test_serve_cli_from_artifact_equals_in_memory(art, capsys):
    out, res = art
    got = serve.main(SERVE + ["--artifact", str(out)])
    text = capsys.readouterr().out
    assert "booted artifact" in text and "plan=calibrated" in text
    assert "KiB/token" in text and "graphs 0" in text
    a, b = got["stats"], _in_memory_engine(res)
    assert len(a.results) == 6
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert ra.offload_bytes == rb.offload_bytes
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    assert a.cache_hbm_bytes_per_token > 0


def test_serve_cli_refuses_another_seed(art):
    out, _ = art
    args = SERVE[:-1] + ["2", "--artifact", str(out)]
    with pytest.raises(ValueError, match="seed"):
        serve.main(args)


def test_serve_cli_fixed_batch_and_in_memory_offload(capsys):
    got = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4"])
    assert got["result"].tokens.shape == (2, 4)
    got = serve.main(["--arch", ARCH, "--device", "cpu", "--offload",
                      "--requests", "3", "--slots", "2", "--chunk", "2",
                      "--max-new", "3", "--bytes-per-token", "20000"])
    assert got["stats"].plan_trace is not None
    text = capsys.readouterr().out
    assert "decode" in text and "controller: budget" in text


@pytest.mark.parametrize("flags", [["--page-size", "16"],
                                   ["--page-size", "16", "--prefix-cache"]])
def test_serve_cli_paged(flags, capsys):
    """``--page-size`` / ``--prefix-cache`` serve the scheduled workload
    on a paged KV cache (the same tokens as the contiguous cache) and
    print JAX's ``pages`` line."""
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3",
            "--slots", "2", "--chunk", "2", "--max-new", "3",
            "--prompt-len", "40"]
    base = serve.main(argv)["stats"]
    got = serve.main(argv + flags)
    st = got["stats"]
    assert [r.tokens.tolist() for r in st.results] == \
        [r.tokens.tolist() for r in base.results]
    assert st.page_report["page_size"] == 16
    assert st.cache_hbm_bytes < base.cache_hbm_bytes
    got["engine"]._page_pool.check_leaks()
    assert "pages (" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--spec-k", "2", "--drafter", "ngram"],
    ["--spec-k", "2", "--drafter", "ngram", "--page-size", "16"],
    ["--spec-k", "1", "--drafter", "self"],
    ["--spec-k", "3", "--drafter", "model"]])
def test_serve_cli_spec_k(flags, capsys):
    """``--spec-k`` / ``--drafter`` serve the scheduled workload in
    speculative rounds: greedy, the same tokens as the plain serve, and
    JAX's ``speculative`` line; the self-drafter accepts every draft."""
    base = serve.main(SERVE)["stats"]
    st = serve.main(SERVE + flags)["stats"]
    assert [r.tokens.tolist() for r in st.results] == \
        [r.tokens.tolist() for r in base.results]
    sp = st.spec_report
    assert sp["spec_k"] == int(flags[1]) and sp["rounds"] == st.chunks
    assert 0.0 <= sp["lookahead_accuracy"] <= 1.0
    if "self" in flags:
        assert sp["acceptance_rate"] == 1.0
    assert "speculative (k=" in capsys.readouterr().out


def test_serve_cli_spec_k_needs_requests():
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--spec-k", "2"])


def test_serve_cli_prefix_cache_needs_page_size():
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                    "--prefix-cache"])


@pytest.mark.parametrize("flags", [
    ["--stream"],
    ["--stream", "--stream-miss", "degrade"],
    ["--stream", "--stream-ring", "3"],
    ["--stream", "--stream-fallback-bits", "4"],
])
def test_serve_cli_stream_flags_run(flags, capsys):
    """Each stream flag serves (reduced Mixtral-8x7B, LRU 3 of 8): every
    store's metered bytes equal the bytes its copies put on the link,
    the flag reaches the stream engine, and the CLI prints JAX's
    ``stream (...)`` line."""
    got = serve.main(["--arch", ARCH, "--device", "cpu", "--offload",
                      "--requests", "3", "--slots", "2", "--chunk", "2",
                      "--max-new", "3", "--prompt-len", "12",
                      "--cache-experts", "3"] + flags)
    eng, sr = got["engine"], got["stats"].stream_report
    assert sr is not None and sr["issued_copies"] > 0
    for s in eng._stores:
        assert s.total_bytes == s.observed_copy_bytes > 0
    want = {"--stream-miss": ("miss_policy", "degrade"),
            "--stream-ring": ("ring_slots", 3),
            "--stream-fallback-bits": ("fallback_bits", 4)}
    key, val = want.get(flags[-2] if len(flags) > 1 else "",
                        ("miss_policy", "block"))
    assert sr[key] == val
    if sr["miss_policy"] == "block":
        assert sr["degraded_tokens"] == 0
    text = capsys.readouterr().out
    assert f"stream ({sr['miss_policy']}, ring {sr['ring_slots']})" in text
    assert "MiB observed ==" in text


def test_serve_cli_stream_needs_offload():
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                    "--stream"])


def test_clis_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress.main(["--arch", ARCH, "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH])
    with pytest.raises(SystemExit):
        compress.main(["--arch", "llama3.2-3b", "--out", str(tmp_path),
                       "--device", "cpu"])
