"""Structure-carrying artifact codec (port of the artifact half of
``repro/checkpoint/manager.py``; its ``CheckpointManager`` is training
and is not ported).

The codec serializes the structure itself: containers recurse, and
registered dataclasses (``QuantizedTensor`` / ``CompressedExpertStack``,
registered by ``calib.artifact``) record their class name and static
meta fields in the JSON spec while their tensor fields go to the npz.
The files are the JAX package's format, class names and meta fields
included, so either package reads what the other wrote.  bfloat16
tensors are stored as their ``uint16`` view under the dtype name
``"bfloat16"`` and restored with ``torch.bfloat16`` (no ``ml_dtypes``).
Restore is exact: same classes, same meta (lists back to tuples),
bit-identical tensors, placed on the device the caller names.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from .. import resolve_device

ARTIFACT_TYPES: Dict[str, Type] = {}


def register_artifact_dataclass(cls: Type,
                                meta_fields: Tuple[str, ...]) -> Type:
    """Make ``cls`` (a dataclass) round-trippable by the codec.
    ``meta_fields`` are the static (JSON-encoded) fields; every other
    public dataclass field is tensor data (recursively encoded).  Fields
    whose name starts with ``_`` are runtime caches and stay out of the
    file."""
    ARTIFACT_TYPES[cls.__name__] = cls
    setattr(cls, "_artifact_meta_fields", tuple(meta_fields))
    return cls


def _npz_safe(t: torch.Tensor):
    """(storable numpy array, dtype name): bfloat16 goes to the file as
    its uint16 view, as the JAX package writes it."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _npz_restore(arr: np.ndarray, dtype_name: str,
                 device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.require(arr, requirements="C").view(np.int16)) \
            .view(torch.bfloat16)
    elif arr.dtype.name == dtype_name:
        t = torch.from_numpy(np.require(arr, requirements="C"))
    else:
        raise ValueError(f"artifact leaf stored as {arr.dtype.name} "
                         f"claims dtype {dtype_name!r}")
    return t.to(device)


def _full_checksum(arrays: Dict[str, np.ndarray]) -> str:
    """Whole-content hash: corruption anywhere fails the load."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
        h.update(str(arrays[k].shape).encode())
    return h.hexdigest()[:16]


def _meta_to_json(v):
    if isinstance(v, tuple):
        return {"__tuple__": [_meta_to_json(x) for x in v]}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _meta_from_json(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_meta_from_json(x) for x in v["__tuple__"])
    return v


def _encode_tree(tree, arrays: Dict[str, np.ndarray]) -> Dict:
    """Tree -> JSON-able spec; tensor leaves appended to ``arrays``."""
    if tree is None:
        return {"kind": "none"}
    if type(tree).__name__ in ARTIFACT_TYPES and dataclasses.is_dataclass(tree):
        meta_names = tree._artifact_meta_fields
        data_names = [f.name for f in dataclasses.fields(tree)
                      if f.name not in meta_names
                      and not f.name.startswith("_")]
        return {
            "kind": "dataclass",
            "cls": type(tree).__name__,
            "meta": {n: _meta_to_json(getattr(tree, n)) for n in meta_names},
            "data": {n: _encode_tree(getattr(tree, n), arrays)
                     for n in data_names},
        }
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": {k: _encode_tree(v, arrays)
                          for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_encode_tree(v, arrays) for v in tree]}
    key = f"a{len(arrays):06d}"
    stored, dtype_name = _npz_safe(torch.as_tensor(tree))
    arrays[key] = stored
    return {"kind": "leaf", "key": key, "dtype": dtype_name}


def _decode_tree(spec: Dict, arrays: Dict[str, np.ndarray],
                 device: torch.device):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "leaf":
        return _npz_restore(arrays[spec["key"]], spec["dtype"], device)
    if kind == "dict":
        return {k: _decode_tree(v, arrays, device)
                for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        items = [_decode_tree(v, arrays, device) for v in spec["items"]]
        return tuple(items) if kind == "tuple" else items
    if kind == "dataclass":
        cls = ARTIFACT_TYPES.get(spec["cls"])
        if cls is None:
            raise KeyError(f"artifact references unregistered dataclass "
                           f"{spec['cls']!r}; register it via "
                           f"register_artifact_dataclass before loading")
        kw = {n: _meta_from_json(v) for n, v in spec["meta"].items()}
        kw.update({n: _decode_tree(v, arrays, device)
                   for n, v in spec["data"].items()})
        return cls(**kw)
    raise ValueError(f"bad artifact spec kind {kind!r}")


def save_artifact(path, tree: Any, meta: Optional[Dict] = None) -> Dict:
    """Serialize a dataclass tree of tensors + metadata to ``path``
    (``path/artifact.npz`` + ``path/artifact.json``), atomically (data
    first, manifest last = commit point), with a content checksum.
    Returns the manifest."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    spec = _encode_tree(tree, arrays)
    tmp_npz = path / "artifact.npz.tmp"
    with open(tmp_npz, "wb") as f:
        np.savez(f, **arrays)
    manifest = {
        "spec": spec,
        "meta": meta or {},
        "time": time.time(),
        "checksum": _full_checksum(arrays),
        "n_tensors": len(arrays),
        "bytes": int(sum(v.nbytes for v in arrays.values())),
    }
    tmp_man = path / "artifact.json.tmp"
    tmp_man.write_text(json.dumps(manifest))
    os.replace(tmp_npz, path / "artifact.npz")
    os.replace(tmp_man, path / "artifact.json")
    return manifest


def load_artifact(path, device=None) -> Tuple[Any, Dict]:
    """Inverse of :func:`save_artifact`, tensors on ``device`` (default:
    the CUDA device; raises if there is none); validates the content
    checksum (a torn or corrupt artifact fails loudly)."""
    dev = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "artifact.json").read_text())
    with np.load(path / "artifact.npz") as z:
        arrays = {k: z[k] for k in z.files}
    if _full_checksum(arrays) != manifest["checksum"]:
        raise IOError(f"artifact checksum mismatch in {path}")
    return _decode_tree(manifest["spec"], arrays, dev), manifest
