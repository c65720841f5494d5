"""Fault-tolerant training checkpoints: atomic, keep-k, with a
checksummed manifest (port of ``repro/checkpoint/manager.py``'s
``CheckpointManager``, written with the port's artifact codec).

- A tree (dicts, lists, tuples and named tuples of tensors) is saved
  unsharded, as an .npz of its leaves plus a JSON manifest carrying the
  codec's structure spec;
- writes go to ``step_XXXXXXXX.*.tmp`` then ``os.replace`` (atomic on
  POSIX): data first, manifest last = commit point, so a crash mid-write
  never corrupts the latest checkpoint;
- the manifest carries a checksum (each leaf's first 4 KiB, its shape
  and name, as the JAX package samples it); restore validates it and
  falls back to the previous checkpoint on a mismatch or an unreadable
  file (torn-write recovery);
- ``keep`` retention bounds disk; ``latest_step`` scans only committed
  manifests.

``restore(template, step, device=)`` rebuilds the template's structure
(types, shapes and dtypes checked) on ``device`` (default: each leaf
where the template's is); the JAX package's ``shardings`` re-shard onto
a mesh and wait for ROADMAP A13b (training on a mesh).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .artifact import _decode_tree, _encode_tree


def _checksum(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:4096])
        h.update(str(arrays[k].shape).encode())
    return h.hexdigest()[:16]


def _into(template, tree, device, path: str = ""):
    """``tree`` (as the codec decodes it: dicts, lists and tuples) in the
    structure and dtypes of ``template``, on ``device`` or each template
    leaf's device."""
    if isinstance(template, dict):
        if set(template) != set(tree):
            raise ValueError(f"keys differ at {path or '/'}: "
                             f"{sorted(tree)} vs {sorted(template)}")
        return {k: _into(v, tree[k], device, f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(tree):
            raise ValueError(f"length differs at {path or '/'}: "
                             f"{len(tree)} vs {len(template)}")
        items = [_into(v, t, device, f"{path}/{i}")
                 for i, (v, t) in enumerate(zip(template, tree))]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {path}: "
                         f"{tuple(tree.shape)} vs {tuple(template.shape)}")
    return tree.to(device=template.device if device is None else device,
                   dtype=template.dtype)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None
             ) -> Path:
        arrays: Dict[str, np.ndarray] = {}
        spec = _encode_tree(tree, arrays)
        tmp_npz = self.dir / f"step_{step:08d}.npz.tmp"
        final_npz = self.dir / f"step_{step:08d}.npz"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "checksum": _checksum(arrays),
            "n_tensors": len(arrays),
            "bytes": int(sum(v.nbytes for v in arrays.values())),
            "extra": extra or {},
            "spec": spec,
        }
        tmp_man = self.dir / f"step_{step:08d}.json.tmp"
        final_man = self.dir / f"step_{step:08d}.json"
        tmp_man.write_text(json.dumps(manifest))
        os.replace(tmp_npz, final_npz)      # atomic commits: data first,
        os.replace(tmp_man, final_man)      # manifest last = commit point
        self._retain()
        return final_npz

    def _retain(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            for suffix in (".npz", ".json"):
                p = self.dir / f"step_{s:08d}{suffix}"
                if p.exists():
                    p.unlink()

    # -- read ---------------------------------------------------------------
    def all_steps(self):
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("step_*.json"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template`` (shapes validated),
        the newest valid checkpoint unless ``step`` names one."""
        if shardings is not None:
            raise NotImplementedError("restoring onto shardings is not "
                                      "ported yet: ROADMAP A13b (training "
                                      "on a mesh)")
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            candidates = steps[::-1]
        else:
            candidates = [step]
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                return self._restore_one(template, s, device)
            except Exception as e:  # torn write -> try previous
                last_err = e
        raise last_err

    def _restore_one(self, template, step: int, device):
        man = json.loads((self.dir / f"step_{step:08d}.json").read_text())
        with np.load(self.dir / f"step_{step:08d}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        if _checksum(arrays) != man["checksum"]:
            raise IOError(f"checksum mismatch at step {step}")
        tree = _decode_tree(man["spec"], arrays, torch.device("cpu"))
        dev = None if device is None else torch.device(device)
        return _into(template, tree, dev), man
