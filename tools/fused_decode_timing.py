#!/usr/bin/env python3
"""Kernel 1's decode path on one CUDA card, alone: builds the kernels,
prints the registers and spills of the decode main kernel's
instantiations, and runs ``chip_smoke.fused_decode_parts`` (the call, the
rank-space pre-pass, the main kernel, the K walk alone (rank cap 0)
beside its byte bound, the epilogue) at Mixtral-8x7B's w1 (E 8, K 4096,
N 14336, top-2, top-n 1) and DeepSeek-MoE-16B's w1 and w2 (E 64, K 2048 /
1408, N 1408 / 2048, top-6, top-n 3, pad_rank 1024 on four experts), at
C 4 (a decode step of batch 4) and C 16 (a verify round), on random 2-bit
stacks from a seed and dispatch-like inputs.

    python3 tools/fused_decode_timing.py                # this tree
    python3 tools/fused_decode_timing.py --src OTHER/src

``--src`` times the ``repro_torch`` package of another checkout (an
earlier commit unpacked with ``git archive``) with this tree's timing
code, so two versions of the kernel can be compared on one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]

# (label, projection, E, K, N, top_k, top_n, pad_rank, experts at pad_rank)
SHAPES = (("mixtral", "w1", 8, 4096, 14336, 2, 1, 64, 3),
          ("deepseek", "w1", 64, 2048, 1408, 6, 3, 1024, 4),
          ("deepseek", "w2", 64, 1408, 2048, 6, 3, 1024, 4))


def random_stack(cs, gen, dev, E, K, N, R, n_ranked):
    """A 2-bit g64 CompressedExpertStack with random planes, scale/zero and
    int8 factors (``chip_smoke.random_stack_inputs``); experts 0 ..
    n_ranked - 1 at rank R, the others 0."""
    from repro_torch.core.pipeline import CompressedExpertStack
    args = cs.random_stack_inputs(gen, dev, E, 1, K, N, R, 2, False,
                                  "full", False)
    _, planes, scale, zero, u, u_scale, v, v_scale = args[:8]
    return CompressedExpertStack(
        planes=planes, scale=scale, zero=zero, u=u, v=v, u_scale=u_scale,
        v_scale=v_scale, bits=2, group_size=64, shape=(E, K, N),
        ranks=tuple(R if e < n_ranked else 0 for e in range(E)),
        pad_rank=R, factor_bits=8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}; kernels from {Path(args.src).resolve()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cufilt = Path(build.nvcc_path()).with_name("cu++filt")
    for name, regs in cs.kernel_resources(build.build_log("fused_expert.cu"),
                                          cufilt):
        if "fused_expert_kernel" in name:
            cs.log(f"    fused_expert.cu: {name}: {regs}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    for label, proj, E, K, N, top_k, top_n, R, n_ranked in SHAPES:
        st = random_stack(cs, gen, dev, E, K, N, R, n_ranked)
        cfg = SimpleNamespace(moe=SimpleNamespace(
            top_k=top_k, quant=SimpleNamespace(top_n_restore=top_n)))
        for C in (4, 16):
            cs.fused_decode_parts(dev, gen, flush, st, cfg, proj, label, C)
        del st
        torch.cuda.empty_cache()
    cs.log(f"  tool took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
