"""Link/compute cost models for the offloading simulator (paper §4.1;
port of ``repro/offload/bandwidth.py``).

Hardware profiles are the paper's two deployments — GPU-only (H100 +
PCIe to host DDR) and GPU-NDP (H100 + 512 GB/s near-data device) — as
the paper states them, not measurements of this card (the JAX file's
TPU host-offload profile is left out: its rates are a TPU's).  A caller
with a measured link rate passes ``dataclasses.replace(GPU_ONLY,
link_bw=...)``.  Times are analytic
(bytes / effective_bandwidth, flops / peak) and feed an event-driven
simulator, the same methodology as MoNDE's Ramulator-backed evaluation at
the granularity the paper reports (tokens/s).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    compute_flops: float          # dense bf16/fp16 peak of the fast device
    hbm_bw: float                 # fast-device memory bandwidth
    link_bw: float                # host<->device transfer bandwidth
    link_latency: float = 8e-6    # per-transfer latency
    ndp_bw: float = 0.0           # near-data device internal bandwidth
    ndp_flops: float = 0.0        # near-data compute (low-bit GEMV-class)

    def transfer_time(self, nbytes: float) -> float:
        return self.link_latency + nbytes / self.link_bw

    def compute_time(self, flops: float) -> float:
        return flops / self.compute_flops

    def hbm_time(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def ndp_compute_time(self, flops: float, nbytes: float) -> float:
        """NDP executes low-bit experts in memory: bandwidth-dominated."""
        t_bw = nbytes / self.ndp_bw if self.ndp_bw else float("inf")
        t_fl = flops / self.ndp_flops if self.ndp_flops else 0.0
        return max(t_bw, t_fl)


# paper §4.1: H100 PCIe (989.4 TFLOPS, 80 GB HBM3); PCIe gen5 x16
# sustains ~25 GB/s effective in Mixtral-Offloading-style pipelines.
GPU_ONLY = HardwareProfile(
    name="gpu-only-h100",
    compute_flops=989.4e12, hbm_bw=3.35e12, link_bw=25e9)

# paper §4.1: NDP device with 512 GB/s internal bandwidth, 512 GB capacity.
GPU_NDP = HardwareProfile(
    name="gpu-ndp-h100",
    compute_flops=989.4e12, hbm_bw=3.35e12, link_bw=25e9,
    ndp_bw=512e9, ndp_flops=16e12)

PROFILES = {p.name: p for p in (GPU_ONLY, GPU_NDP)}
