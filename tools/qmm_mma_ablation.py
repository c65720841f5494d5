#!/usr/bin/env python3
"""Where the time of quant_matmul's tensor-core path goes, on one CUDA card.

    python3 tools/qmm_mma_ablation.py

Builds three variants of ``src/repro_torch/kernels/csrc/quant_matmul.cu``
beside the real kernel (into the git-ignored build directory): one whose
blocks skip the conversion of each pack block (x into its bf16 parts, the
plane words into bf16 codes), one that skips the mma, and one that skips
both, so that only the cp.async ring, the barriers and the fold remain.
Each is timed like ``chip_smoke.py`` times a kernel (CUDA events, stream
held, L2 overwritten before each call) on Llama-3.2-3B's w1 and w2 shapes
without compensation (the mma kernel alone, one launch), at M 16 (one
block per SM) and M 1024 (the prefill).  The variants compute garbage;
only their times mean something.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# variant -> the source edits that make it
CONVERT = "    mma_convert<BITS>(ring + (pb % S::RING) * S::STAGE, op);\n"
MMA = "    for (int kk = 0; kk < PACK / 16; ++kk) {\n"
NO_MMA = "    for (int kk = 0; kk < 0; ++kk) {\n"
VARIANTS = {"full": [], "no convert": [(CONVERT, "")],
            "no mma": [(MMA, NO_MMA)],
            "neither": [(CONVERT, ""), (MMA, NO_MMA)]}


def build_variants(build):
    """One shared library per variant, all nvcc processes at once."""
    src = (build.CSRC / "quant_matmul.cu").read_text()
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"quant_matmul.cu no longer has {old.strip()!r} "
                         "once; update the ablation's edits")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        procs[name] = (out_dir / f"{stem}.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out_dir / f"{stem}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on the {name!r} variant:\n{text[-3000:]}")
        fn = ctypes.CDLL(str(so)).quant_matmul_mma
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import time_ms
    from repro_torch.core.quantize import PLANES
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as qm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for proj, K, N in (("w1", 3072, 8192), ("w2", 8192, 3072)):
        planes = tuple(torch.randint(0, 256, (K * p // 8, N), generator=gen,
                                     device=dev, dtype=torch.int32)
                       .to(torch.uint8) for p, _ in PLANES[2])
        scale = torch.rand((K // 64, N), generator=gen, device=dev) * 0.02
        zero = torch.rand((K // 64, N), generator=gen, device=dev) * 3
        for M in (16, 1024):
            x = torch.randn((M, K), generator=gen, device=dev)
            times = {}
            for name, fn in libs.items():
                qm._qmm_lib = lambda path, fn=fn: fn
                times[name] = time_ms(lambda: qm._launch_qmm(
                    "mma", x, planes, scale, zero, None, None, None, None,
                    None, None, bits=2, group_size=64), 10, flush)["device"]
            print(f"{proj} M={M} K={K} N={N} 2 bits, no compensation, ms on "
                  "the device: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in times.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
