#!/usr/bin/env python3
"""Flash-decode timing on one CUDA card, alone: builds the kernels, prints
the registers and spills of the kernel's hd 128 instantiations, and runs
``chip_smoke.flash_long_timing`` (the slice's S 512 and long context up
to S 32768, each beside its bound, its achieved rate and SDPA, and one
call's kernels by name) and, where the package has the block-table mode,
``chip_smoke.flash_paged_timing`` (paged against contiguous at one S and
against gather + kernel) and, where the package takes G 16, the window
mode at RecurrentGemma-9B's ring (B 4, H 16, KVH 1, hd 256, S 2048 =
window; bf16 and f32) beside its bound and SDPA.

    python3 tools/flash_decode_timing.py                # this tree
    python3 tools/flash_decode_timing.py --src OTHER/src

``--src`` times the ``repro_torch`` package of another checkout (an
earlier commit unpacked with ``git archive``) with this tree's timing
code, so two versions of the kernel can be compared on one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}; kernels from {Path(args.src).resolve()}")
    build.build_all()
    cufilt = Path(build.nvcc_path()).with_name("cu++filt")
    for src in ("flash_decode.cu", "flash_decode_paged.cu"):
        for name, regs in cs.kernel_resources(build.build_log(src), cufilt):
            if "128" in name:
                cs.log(f"    {src}: {name}: {regs}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    row = cs.flash_long_timing(dev, gen, flush)
    cs.log(f"  Mixtral f32 S 32768: {row}")
    from repro_torch.kernels import decode_attention as fd
    if hasattr(fd, "flash_decode_attention_paged"):
        cs.log(f"  paged: {cs.flash_paged_timing(dev, gen, flush)}")
    if hasattr(fd, "group_splits"):
        for kind in ("bf16", "f32"):
            cs.log(f"  G 16 ring {kind}: " + str(cs.flash_window_timing(
                dev, gen, flush, 4, 16, 1, 256, 2048, kind)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
