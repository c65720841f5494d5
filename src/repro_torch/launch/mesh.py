"""Expert-parallel serving mesh on ``torch.distributed`` (port of
``repro/launch/mesh.py``'s serving half).

The JAX package's serving mesh is a 1-D ``('model',)`` device mesh that
one process drives through ``shard_map``.  Here it is SPMD over
processes: one process per shard, each running the same engine on the
same inputs, with the MoE experts sharded and everything else replicated.
``run_ranks`` spawns the processes (``torch.multiprocessing``, start
method ``spawn``) and joins them; inside a rank ``make_serve_mesh(ep)``
returns that rank's ``ServeMesh``, the handle the expert-parallel MoE
layer runs its collectives through.

Ranks meet through a ``file://`` store in a fresh temporary directory (no
TCP port to clash with another run) and every process group carries a
timeout, so a rank that dies or hangs fails the others instead of
leaving them blocked.  The backend is explicit: ``nccl`` (one card per
rank, ``cuda:<rank>``) or ``gloo``.  NCCL refuses two ranks on one card,
so on a one-card machine every rank serves from ``cuda:0`` under gloo,
which takes CUDA tensors for the collectives used here (all-reduce,
all-to-all, all-gather) and copies them through the host itself.  With
gloo every collective is a host call, which a CUDA graph cannot capture:
a mesh engine runs its eager decode loop.

``make_production_mesh`` and ``make_debug_mesh`` (training meshes) are
not ported yet: ROADMAP A13b (training on a mesh).
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..distributed.moe_parallel import EP_AXIS

BACKENDS = ("nccl", "gloo")
# every process group's timeout: a rank that dies or hangs fails the
# collective the others wait in within this many seconds
GROUP_TIMEOUT_S = 120


class ServeMesh:
    """One rank's view of an ``ep``-way expert-parallel serving mesh.

    ``rank`` is the rank's index in its group (its expert slice is
    ``[rank * E/ep, (rank + 1) * E/ep)``), ``group`` the process group its
    collectives run over and ``device`` where it serves.  ``shape``
    mirrors the JAX mesh's, which ``distributed.sharding`` reads.  The collectives time themselves on the host clock
    (``comm_s``, ``comm_calls``)."""

    def __init__(self, ep: int, rank: int, group, device: torch.device,
                 backend: str):
        self.ep = ep
        self.rank = rank
        self.group = group
        self.device = device
        self.backend = backend
        self.comm_s = 0.0
        self.comm_calls = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {EP_AXIS: self.ep}

    def __repr__(self) -> str:
        return (f"ServeMesh(ep={self.ep}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.comm_s += time.perf_counter() - t0
        self.comm_calls += 1
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks (a new tensor)."""
        out = t.contiguous().clone()
        self._timed(lambda: dist.all_reduce(out, group=self.group))
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Split ``t`` along dim 0 into ``ep`` equal chunks, send chunk j
        to rank j; the result stacks the chunks received, by source rank,
        along dim 0."""
        t = t.contiguous()
        out = torch.empty_like(t)
        self._timed(lambda: dist.all_to_all_single(out, t, group=self.group))
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, by rank."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.ep)]
        self._timed(lambda: dist.all_gather(outs, t, group=self.group))
        return torch.cat(outs, dim=0)

    def check_same(self, arr, what: str) -> None:
        """Raise unless ``arr`` is byte-equal on every rank.  The ranks
        run the same program on the same inputs; one that sampled another
        token would send a different tensor into the next collective, or
        wait in another one, so a divergence is caught here first."""
        a = np.ascontiguousarray(np.asarray(arr))
        h = hashlib.sha256(a.tobytes() + str(a.shape).encode()).digest()
        val = torch.tensor([int.from_bytes(h[:7], "little")],
                           dtype=torch.int64, device=self._meta_device)
        got = self.all_gather(val).cpu().tolist()
        if len(set(got)) != 1:
            raise RuntimeError(f"expert-parallel ranks diverged: {what} "
                               f"differs across ranks (hashes {got})")

    @property
    def _meta_device(self) -> torch.device:
        """Where small host-side values go for a collective: NCCL only
        moves CUDA tensors, gloo moves CPU ones without a copy."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a ``--mesh`` serving spec like ``"ep=4"`` into a dict.

    Comma-separated ``axis=N`` entries; only ``ep`` (expert parallelism)
    is currently meaningful for serving."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --mesh entry {part!r}; expected axis=N")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    unknown = set(out) - {"ep"}
    if unknown:
        raise ValueError(f"unknown --mesh axes {sorted(unknown)}; "
                         f"serving supports ep=N")
    return out


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


def make_serve_mesh(ep: int = 1, *, backend: str = "nccl",
                    device=None) -> Optional[ServeMesh]:
    """This rank's ``ServeMesh`` of ``ep`` shards, or None at ``ep <= 1``
    (the single-device path), as the JAX package's ``make_serve_mesh``.

    Call it inside a rank started by ``run_ranks``, on every rank of the
    world at once: a world of W ranks splits into W / ep meshes of
    consecutive ranks (each a process group of its own when W > ep),
    every rank taking part in creating each group.  ``backend`` must be
    the world's.  ``device`` defaults to ``cuda:<rank>`` under NCCL and
    ``cuda:0`` under gloo (pass ``"cpu"`` for CPU ranks)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    if ep <= 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError("make_serve_mesh(ep > 1) runs inside a rank of "
                           "launch.mesh.run_ranks (no process group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() != backend:
        raise ValueError(f"the ranks were started with backend "
                         f"{dist.get_backend()!r}, the mesh asks {backend!r}")
    if world % ep:
        raise ValueError(f"mesh ep={ep} does not divide the {world} ranks")
    if device is None:
        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend moves CUDA tensors only")
    group = None
    if world > ep:
        for lo in range(0, world, ep):
            g = dist.new_group(list(range(lo, lo + ep)), timeout=_timeout(),
                               backend=backend)
            if lo <= rank < lo + ep:
                group = g
    return ServeMesh(ep, rank % ep, group, device, backend)


def _rank_main(rank: int, world: int, backend: str, store: str, out: str,
               fn: Callable, args: Sequence) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=_timeout())
    try:
        result = fn(rank, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *, backend: str = "nccl",
              args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes (one torch
    thread each) that share one process group, and return each rank's
    result in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  Every rank is joined; if one exits with an error
    (or a collective times out), the others are terminated and the error
    is raised here."""
    import torch.multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        mp.start_processes(_rank_main,
                           args=(world, backend, os.path.join(tmp, "rdv"),
                                 tmp, fn, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
