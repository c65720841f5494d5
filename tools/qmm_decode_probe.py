#!/usr/bin/env python3
"""What bounds kernel 3's decode kernel (``qmm_decode_kernel``), on one
CUDA card.

    python3 tools/qmm_decode_probe.py
    python3 tools/qmm_decode_probe.py --src OTHER/src    # part 4 only

At Llama-3.2-3B's projections (w1: K 3072, N 8192; w2: K 8192, N 3072;
2 bits, g64, rank 32, every token compensated), on random weights from a
seed, timed like ``chip_smoke.py`` times a kernel (CUDA events, stream
held, L2 overwritten before each call; "kernel" is the profiler's kernel
time, which leaves the launch out):

1. geometry: the decode kernel at cluster sizes 1 to 4 forced, at M 4,
   8, 16 and 32, beside the one the wrapper takes;
2. fixed cost: kernel time at K 64, 512, 1024 and 3072 (N 8192, M 4, no
   split, so one block per column tile), L2 overwritten or not, with and
   without compensation: what a block costs with one pack block per
   block, and what each further pack block per warp adds;
3. the compensated tail: variants of ``quant_matmul.cu`` built beside the
   real kernel (into the git-ignored build directory), each with one part
   left out (the x @ U rows the walk carries, the xu @ V product, the
   second cluster barrier), at w1 and w2, M 4; the variants compute
   garbage, only their times mean something;
4. the crossover per Llama layer (w1 + w3 + w2): the decode path against
   the tensor-core path at M 8 to 256, through the wrapper's
   ``_launch_qmm``; with ``--src`` the other checkout's package (e.g. the
   parent commit unpacked with ``git archive``), this part only;
5. the instruction mix of ``qmm_decode_kernel<2, 4>`` (``cuobjdump
   -sass``): the whole kernel and its hottest loop (the pack-block walk).

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("w1", 3072, 8192), ("w2", 8192, 3072))
RANK, BITS = 32, 2

# variant -> the edits of quant_matmul.cu that make it
VARIANTS = {
    "full": [],
    "no x@U": [("    if (xu) {\n      const float* xr = xs",
                "    if (false) {\n      const float* xr = xs")],
    "no xu@V": [("    for (int j0 = warp; j0 < own; j0 += WARPS * kVBatch) {",
                 "    for (int j0 = warp; j0 < 0; j0 += WARPS * kVBatch) {")],
    "no 2nd barrier": [("          [(part * CT + c) * L.ych + nn % L.ych] = y;"
                        "\n    }\n    cluster.sync();",
                        "          [(part * CT + c) * L.ych + nn % L.ych] = y;"
                        "\n    }\n    __syncthreads();")],
}


def splitk_fn(lib):
    fn = lib.quant_matmul_splitk
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_variants(build):
    """One shared library per variant, all nvcc processes at once."""
    src = (build.CSRC / "quant_matmul.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"quant_matmul.cu no longer has {old.strip()!r} "
                         "once; update the probe's edits")
            text = text.replace(old, new)
        out_dir = build.BUILD_DIR / "decode_probe" / re.sub(r"\W", "_", name)
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = out_dir / "quant_matmul.cu"
        cu.write_text(text)
        procs[name] = (out_dir / "variant.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out_dir / "variant.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on the {name!r} variant:\n{text[-3000:]}")
        libs[name] = splitk_fn(ctypes.CDLL(str(so)))
    return libs


def launch(fn, a, ks, kch, comp):
    """quant_matmul_splitk of library function ``fn`` at a forced
    geometry (clusters of ``ks`` blocks of ``kch`` pack blocks)."""
    from repro_torch.kernels.build import check
    x, planes, scale, zero, u, us, v, vs, mask, cap = a
    M, K = x.shape
    N = scale.shape[-1]
    out = torch.empty((M, N), device=x.device)

    def p(t):
        return None if t is None else t.data_ptr()
    f = (p(u), p(us), p(v), p(vs), p(mask), p(cap)) if comp else (None,) * 6
    check(fn(p(x), p(planes[0]), None, p(scale), p(zero), *f, None, None,
             p(out), M, K, N, RANK if comp else 0, ks, kch, BITS, 64,
             torch.cuda.current_stream().cuda_stream), "quant_matmul_splitk")
    return out


def split(K, cs):
    n_pb = K // 64
    kch = -(-n_pb // cs)
    return -(-n_pb // kch), kch


def kernel_ms(cs, fn, flush):
    return sum(ms for ms, _ in cs.kernels_by_name(fn, flush, 30).values())


def crossover(cs, qm, dev, gen, flush):
    res = {}
    for proj, K, N in SHAPES:
        for M in (8, 16, 32, 48, 64, 96, 128, 256):
            a = cs.qmm_case_inputs(gen, dev, M, K, N, RANK, BITS, "ones")
            res[proj, M] = {p: cs.time_ms(lambda: qm._launch_qmm(
                p, *a, bits=BITS, group_size=64), 20, flush)["device"]
                for p in ("splitk", "mma")}
    for M in sorted({m for _, m in res}):
        lay = {p: 2 * res["w1", M][p] + res["w2", M][p]
               for p in ("splitk", "mma")}
        cs.log(f"  crossover per layer M={M}: decode path "
               f"{lay['splitk']:.4f} ms, tensor cores {lay['mma']:.4f} ms")


def sass_mix(cs, build):
    """Instruction mix of qmm_decode_kernel<2, 4> and its hottest loop."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass",
                           str(build.library_path("quant_matmul.cu"))],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", text)
                if "qmm_decode_kernelILi2ELi4E" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2).split()[0].split(".")[0])
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                                r"([A-Z][A-Z0-9_.]*)[^;]*;", body)]
    loops = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?P\w+\s+)?BRA"
                         r"\s+(?:\S+\s*,\s*)?(?:`\()?(?:\.L_x_\d+|0x"
                         r"([0-9a-f]+))", body):
        if m.group(2) and int(m.group(2), 16) < int(m.group(1), 16):
            loops.append((int(m.group(2), 16), int(m.group(1), 16)))

    def mix(a, b):
        return collections.Counter(op for at, op in ins if a <= at <= b)

    def ffma_share(ab):
        c = mix(*ab)
        return c["FFMA"] / sum(c.values()) if c["FFMA"] >= 64 else 0.0
    whole = mix(0, 1 << 40)
    cs.log(f"  qmm_decode_kernel<2, 4>: {sum(whole.values())} instructions, "
           f"{whole.most_common(8)}")
    if loops:       # the walk: the loop densest in multiply-adds
        a, b = max(loops, key=ffma_share)
        c = mix(a, b)
        cs.log(f"  its walk loop ({hex(a)}..{hex(b)}): {sum(c.values())} "
               f"instructions a pack block, {c.most_common(8)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None,
                    help="directory holding another repro_torch package "
                         "(times its crossover only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(Path(args.src or ROOT / "src").resolve())]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as qm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}; kernels from {Path(qm.__file__).parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    if args.src is not None:
        cs.log("== 4. crossover")
        crossover(cs, qm, dev, gen, flush)
        return 0
    real = splitk_fn(build.load("quant_matmul.cu"))

    def device_ms(fn):
        return cs.time_ms(fn, 30, flush)["device"]

    cs.log("== 1. geometry: forced cluster sizes (device ms, compensated)")
    for proj, K, N in SHAPES:
        for M in (4, 8, 16, 32):
            a = cs.qmm_case_inputs(gen, dev, M, K, N, RANK, BITS, "ones")
            row = []
            for c in (1, 2, 3, 4):
                ks, kch = split(K, c)
                t = device_ms(lambda: launch(real, a, ks, kch, True))
                row.append(f"{ks}x{kch} {t:.4f}")
            ks, kch = qm.decode_splits(dev, M, K, N, RANK, BITS)
            cs.log(f"  {proj} M={M}: " + ", ".join(row) +
                   f"; the wrapper takes {ks}x{kch}")

    cs.log("== 2. fixed cost (kernel ms, M 4, N 8192, one block per tile)")
    warm = torch.empty(16, dtype=torch.uint8, device=dev)
    for K, c in ((64, 1), (512, 1), (1024, 1), (3072, 2)):
        a = cs.qmm_case_inputs(gen, dev, 4, K, 8192, RANK, BITS, "ones")
        ks, kch = split(K, c)
        row = []
        for fl, what in ((flush, "cold"), (warm, "warm")):
            for comp in (False, True):
                t = kernel_ms(cs, lambda: launch(real, a, ks, kch, comp), fl)
                row.append(f"{what} {'comp' if comp else 'walk'} {t:.4f}")
        cs.log(f"  K={K} ({max(kch // 8, 1)} pack blocks per warp, "
               f"clusters of {ks}): " + ", ".join(row))

    cs.log("== 3. the compensated tail (kernel ms, M 4)")
    libs = build_variants(build)
    for proj, K, N in SHAPES:
        a = cs.qmm_case_inputs(gen, dev, 4, K, N, RANK, BITS, "ones")
        ks, kch = qm.decode_splits(dev, 4, K, N, RANK, BITS)
        row = []
        for name, fn in libs.items():
            t = kernel_ms(cs, lambda: launch(fn, a, ks, kch, True), flush)
            row.append(f"{name} {t:.4f}")
        t = kernel_ms(cs, lambda: launch(real, a, ks, kch, False), flush)
        cs.log(f"  {proj}: " + ", ".join(row) + f", no compensation {t:.4f}")

    cs.log("== 4. crossover")
    crossover(cs, qm, dev, gen, flush)
    cs.log("== 5. instruction mix")
    sass_mix(cs, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
