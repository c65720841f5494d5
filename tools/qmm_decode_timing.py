#!/usr/bin/env python3
"""Kernel 3's decode path on one CUDA card, alone: builds the kernels,
prints the registers and spills of the decode instantiations, the decode
kernel's occupancy (blocks per SM, clusters resident at once by cluster
size) and the geometry the wrapper takes, then times ``quant_matmul`` at
Llama-3.2-3B's projections (w1 / w3: K 3072, N 8192; w2: K 8192, N
3072; 2 bits, g64, rank 32, every token compensated) at M 1, 4 and 16 on
random weights from a seed: the call, the walk alone (the same call
without compensation) and the byte bound (``chip_smoke.qmm_bytes_ops``
at 3.35 TB/s), and lists one call's kernels by name from the profiler.

    python3 tools/qmm_decode_timing.py                # this tree
    python3 tools/qmm_decode_timing.py --src OTHER/src

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

import torch

ROOT = Path(__file__).resolve().parents[1]

# (projection, K, N) of Llama-3.2-3B's dense FFN
SHAPES = (("w1", 3072, 8192), ("w3", 3072, 8192), ("w2", 8192, 3072))
RANK, BITS = 32, 2


def geometry(qm, dev, M, K, N, R) -> str:
    """The decode launch the wrapper takes: its cluster size and pack
    blocks per block (the earlier split-K kernel: K splits)."""
    if hasattr(qm, "decode_splits"):
        cs, kch = qm.decode_splits(dev, M, K, N, R, BITS)
        blocks = cs * -(-M // qm.token_tile(M)) * -(-N // qm.QMM_BN)
        return (f"cluster {cs} x {kch} pack blocks ({kch / qm.QMM_WARPS:.2f} "
                f"per warp), {blocks} blocks")
    ks, kch = qm.qmm_splits(M, K, N)
    return f"K-splits {ks} x {kch} pack blocks"


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
    from repro_torch.kernels import quant_matmul as qm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}; kernels from {Path(args.src).resolve()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cufilt = Path(build.nvcc_path()).with_name("cu++filt")
    for name, regs in cs.kernel_resources(build.build_log("quant_matmul.cu"),
                                          cufilt):
        if "qmm_" in name and "mma" not in name:
            cs.log(f"    quant_matmul.cu: {name}: {regs}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(qm, "decode_occupancy"):
        for M in (1, 4, 16):
            occ = [qm.decode_occupancy(dev, BITS, M, RANK, c)
                   for c in range(1, qm.QMM_MAX_CLUSTER + 1)]
            cs.log(f"  occupancy bits={BITS} M={M} R={RANK}: {occ[0][1]} "
                   f"blocks per SM; clusters resident at once by size "
                   + ", ".join(f"{c}: {n}" for c, (n, _) in
                               enumerate(occ, 1)) + f"; {sms} SMs")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    for proj, K, N in SHAPES:
        for M in (1, 4, 16):
            a = cs.qmm_case_inputs(gen, dev, M, K, N, RANK, BITS, "ones")
            kw = dict(bits=BITS, group_size=64, require_kernel=True)
            call = cs.time_ms(lambda: qm.quant_matmul(*a, **kw), 50, flush)
            walk = cs.time_ms(lambda: qm.quant_matmul(*a[:4], **kw), 50,
                              flush)
            nb, ops = cs.qmm_bytes_ops(M, K, N, a[1], RANK)
            bms, by = cs.bound(nb, ops)
            cs.log(f"  quant_matmul {proj} M={M} K={K} N={N}: call "
                   f"{cs._fmt(call)}; walk alone (no compensation) "
                   f"{cs._fmt(walk)}; bound {bms:.4f} ms ({by}, "
                   f"{nb / 1e6:.2f} MB); {geometry(qm, dev, M, K, N, RANK)}")
            if proj == "w1" and M == 4:
                for what, fn in (("compensated", lambda: qm.quant_matmul(
                        *a, **kw)), ("uncompensated", lambda: qm.quant_matmul(
                        *a[:4], **kw))):
                    by_name = cs.kernels_by_name(fn, flush, calls=20)
                    cs.log(f"  kernels of one {what} call (profiler, 20 "
                           f"calls): " + "; ".join(
                               f"{n[:60]} x{c / 20:g} {ms:.4f} ms"
                               for n, (ms, c) in by_name.items()))
            del a
    cs.log(f"  tool took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
