#!/usr/bin/env python3
"""Where the budget allocator's time goes on the card, at Qwen3-MoE-
30B-A3B's expert shape (E 128, d_model 2048, d_expert 768, f32).

    python3 tools/alloc_table_timing.py        # on a machine with a card

``calib/allocate.py::_projection_tables`` builds, per (layer, projection)
and candidate width, an HQQ over the (E, K, N) stack and E eigenvalue
problems of the residuals' 768 x 768 float64 Gram matrices.  This times
each part apart (the HQQ; ``torch.linalg.eigvalsh`` over the batch on
one stream, and split over 4 host threads with a stream each), then one
whole ``_projection_tables`` call over the four default widths.  Device
work is finished (synchronised) inside each timed region.  Prints the
card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def timed(fn, dev) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.calib.allocate import (DEFAULT_BITS_CANDIDATES,
                                            _projection_tables)
    from repro_torch.config import QuantConfig
    from repro_torch.core.hqq import hqq_params
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    E, K, N = 128, 2048, 768
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((E, K, N), generator=gen, device=dev) * 0.02
    q = QuantConfig(enabled=True, bits=2, rank_budget=64)
    hqq_params(w[:2], 2, 64, q.hqq_iters)            # warm-up
    t = timed(lambda: hqq_params(w, 2, 64, q.hqq_iters, q.hqq_p, q.hqq_beta,
                                 q.hqq_beta_scale), dev)
    print(f"HQQ ({q.hqq_iters} iterations) over the ({E}, {K}, {N}) stack: "
          f"{t:.4f} s")
    r = w.double()
    gram = r.mT @ r
    del r
    torch.linalg.eigvalsh(gram[:2])                  # warm-up
    t1 = timed(lambda: torch.linalg.eigvalsh(gram), dev)
    print(f"eigvalsh of {E} {N} x {N} f64 Grams, one stream: {t1:.4f} s "
          f"({t1 / E * 1e3:.2f} ms each)")
    streams = [torch.cuda.Stream(dev) for _ in range(4)]
    parts = list(torch.chunk(gram, 4))

    def solve(i):
        with torch.cuda.stream(streams[i]):
            out = torch.linalg.eigvalsh(parts[i])
        streams[i].synchronize()
        return out

    def threaded():
        with ThreadPoolExecutor(4) as ex:
            return list(ex.map(solve, range(4)))
    t4 = timed(threaded, dev)
    print(f"eigvalsh of the same, 4 threads with a stream each: {t4:.4f} s "
          f"({t4 / E * 1e3:.2f} ms each)")
    mom = np.abs(np.random.default_rng(0).standard_normal((E, K))) + 0.1
    tt = timed(lambda: _projection_tables(w, q, DEFAULT_BITS_CANDIDATES,
                                          mom), dev)
    print(f"_projection_tables of one projection at widths "
          f"{DEFAULT_BITS_CANDIDATES}: {tt:.4f} s "
          f"({tt / len(DEFAULT_BITS_CANDIDATES):.4f} s per width)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
