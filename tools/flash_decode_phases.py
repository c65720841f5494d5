#!/usr/bin/env python3
"""Where one flash-decode call's time goes, on one CUDA card.

    python3 tools/flash_decode_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/flash_decode.cu`` whose
thread 0 of each block reads the card's global timer at seven points
(kernel entry; the first tiles' positions in shared memory; the tile loop
done; the block's warps merged; the first cluster barrier passed; the
block's share of the outputs written; the last cluster barrier passed)
into a device array, and an empty kernel launched with the same grid and
cluster size and 64 KB of shared memory (about one block's of the kernel).  Both go into the git-ignored build
directory.  At Mixtral-8x7B's decode shape (B 4, H 32, KVH 8, hd 128, f32
cache) for the slice's S 512 with 288 valid slots and for S 4096, it
prints each point's median and latest time over the blocks, in µs from
the first block's entry, with L2 overwritten before the call; and the
empty kernel's time as ``chip_smoke.time_ms`` measures a kernel (the
floor of that method for this launch shape).  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

STAMP = ("  if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_phase[(blockIdx.x"
         " + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 8 + {i}] ="
         " t_; }}\n")
# (anchor in the kernel source, phase, stamp after the anchor?)
PHASES = [("  const bool scaled = ks != nullptr;\n", "entry", True),
          ("every lane's positions\n", "positions in", True),
          ("the ring becomes the warp-merge area\n", "tiles done", True),
          ("  // merge the cluster's blocks, in rank order", "block merged",
           False),
          ("  auto rbm = [&]", "cluster barrier 1", False),
          ("  cluster.sync();                   // no block leaves",
           "outputs written", False)]
LAST = "  cluster.sync();                   // no block leaves while it is read\n"
EMPTY = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void empty_kernel(float* p) {
  extern __shared__ float sm[];
  if (threadIdx.x == 0) p[blockIdx.x] = (float)(size_t)sm;
}
extern "C" int launch_empty(int cl, int smem, int gy, int gz, float* p,
                            cudaStream_t s) {
  cudaFuncSetAttribute(empty_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, gy, gz);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = cl;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int rc = (int)cudaLaunchKernelEx(&cfg, empty_kernel, p);
  return rc ? rc : (int)cudaGetLastError();
}
"""


def instrumented(src: str) -> str:
    """The kernel source with the stamps and a reader of them."""
    for i, (anchor, _, after) in enumerate(PHASES):
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once in flash_decode.cu: {anchor!r}")
        at = src.index(anchor)
        if after:
            at = src.index("\n", at) + 1
        src = src[:at] + STAMP.format(i=i) + src[at:]
    src = src.replace(LAST, LAST + STAMP.format(i=len(PHASES)))
    return src.replace(
        "namespace cg = cooperative_groups;",
        "namespace cg = cooperative_groups;\n"
        "__device__ unsigned long long g_phase[65536];\n"
        "extern \"C\" int phase_read(unsigned long long* h) {\n"
        "  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}")


def build(out: Path):
    """(instrumented kernel library, empty kernel library), built by two
    nvcc processes at once."""
    from repro_torch.kernels import build as kb
    out.mkdir(parents=True, exist_ok=True)
    (out / "phases.cu").write_text(
        instrumented((kb.CSRC / "flash_decode.cu").read_text()))
    (out / "empty.cu").write_text(EMPTY)
    procs = [subprocess.Popen(
        [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
         str(out / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in ("phases", "empty")]
    for p in procs:
        text, _ = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc failed:\n{text[-4000:]}")
    return (ctypes.CDLL(str(out / "phases.so")),
            ctypes.CDLL(str(out / "empty.so")))


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import decode_attention as fd
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(f"card {smi}")
    lib, empty = build(kb.BUILD_DIR / "phases")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_forward.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.flash_decode_max_clusters.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    empty.launch_empty.argtypes = [i] * 4 + [p, p]
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    names = [name for _, name, _ in PHASES] + ["exit"]

    def capacity(cl):
        n = ctypes.c_int(0)
        kb.check(lib.flash_decode_max_clusters(0, 128, 4, cl,
                                               ctypes.byref(n)), "capacity")
        return n.value

    for S, filled in ((512, 288), (4096, 4096)):
        q, k, v, pos, cur, _, _ = cs.flash_inputs(gen, dev, 4, 32, 8, 128, S,
                                                  filled)
        out = torch.empty_like(q)
        cl = fd.launch_geometry(32, S, fd.slots_per_warp(128, 4), capacity)
        for _ in range(3):          # the last of three calls is read
            flush.bitwise_not_()
            torch.cuda._sleep(2000000)
            kb.check(lib.flash_decode_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                pos.data_ptr(), cur.data_ptr(), out.data_ptr(), 4, S, 32, 8,
                128, 0, cl, 0, stream), "flash_decode_forward")
            torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 65536)()
        kb.check(lib.phase_read(h), "phase_read")
        t = np.frombuffer(h, dtype=np.uint64)[:cl * 32 * 8]
        t = t.reshape(-1, 8)[:, :len(names)].astype(np.int64)
        t = (t - t[:, 0].min()) / 1e3
        cs.log(f"  flash_decode phases B=4 H=32 KVH=8 hd=128 S={S} valid="
               f"{filled} f32, cluster {cl}, {t.shape[0]} blocks; µs from the "
               f"first entry, median / latest block:")
        cs.log("    " + "; ".join(f"{n} {np.median(t[:, j]):.2f} / "
                                 f"{t[:, j].max():.2f}"
                                 for j, n in enumerate(names)))
        del q, k, v, pos, cur, out
    buf = torch.zeros(4096, device=dev)
    smem = 64 * 1024
    for cl in (1, 8):
        def call():
            kb.check(empty.launch_empty(cl, smem, 8, 4, buf.data_ptr(),
                                        stream), "launch_empty")
        t = cs.time_ms(call, 20, flush)
        cs.log(f"  empty kernel, grid ({cl}, 8, 4) in clusters of {cl}, "
               f"{smem} B of shared memory: {t['device']:.4f} ms on the "
               f"device (chip_smoke.time_ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
