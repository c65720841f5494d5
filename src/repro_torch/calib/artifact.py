"""Calibration stage 3: serialized compression artifacts.

Port of ``repro/calib/artifact.py``.  One directory per artifact
(``artifact.npz`` + ``artifact.json``, the codec of
``checkpoint/artifact.py``) holding the per-MoE-layer
``CompressedExpertStack`` dicts that ``compress_moe_params`` produces,
the ``CompressionPlan`` that produced them (JSON, in the manifest), and
a config fingerprint + params seed for the boot-time compatibility
check.  The files are the JAX package's: an artifact either package
wrote boots the other's ``launch/serve.py --artifact``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

from .. import resolve_device
from ..checkpoint.artifact import (load_artifact, register_artifact_dataclass,
                                   save_artifact)
from ..config import ModelConfig
from ..core.pipeline import CompressedExpertStack
from ..core.quantize import QuantizedTensor
from .allocate import CompressionPlan

ARTIFACT_VERSION = 1

# the compression dataclasses the codec round-trips, with the JAX
# package's class names and static (meta) fields
register_artifact_dataclass(QuantizedTensor,
                            ("bits", "group_size", "shape"))
register_artifact_dataclass(CompressedExpertStack,
                            ("bits", "group_size", "shape", "ranks",
                             "pad_rank", "factor_bits", "expert_bits"))

# Fields of the JAX package's config classes that the port's copies do
# not carry (the port runs none of the models that set them), at the
# reference's defaults.  The fingerprint hashes the port's fields plus
# these, so it equals the hash the JAX package computes for the same
# model and artifacts cross between the packages.
REFERENCE_ONLY_FIELDS: Dict[str, Dict] = {
    "MoEConfig": {"router_jitter": 0.0},
    "QuantConfig": {"scale_dtype": "f32", "compensate_shared": True,
                    "factor_group_size": 64},
}


def _reference_dict(obj):
    """``dataclasses.asdict`` of a port config with the reference-only
    fields of ``REFERENCE_ONLY_FIELDS`` filled in, recursively."""
    if not dataclasses.is_dataclass(obj):
        return obj
    d = {f.name: _reference_dict(getattr(obj, f.name))
         for f in dataclasses.fields(obj)}
    for k, v in REFERENCE_ONLY_FIELDS.get(type(obj).__name__, {}).items():
        d.setdefault(k, v)
    return d


def config_fingerprint(cfg: ModelConfig) -> str:
    """Stable hash of everything the artifact layout depends on (the
    JAX package's ``config_fingerprint``): restoring onto a config with
    another expert geometry or quant recipe fails the check."""
    blob = json.dumps(_reference_dict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_compression_artifact(path, cfg: ModelConfig,
                              stacks_by_layer: List[Dict],
                              plan: Optional[CompressionPlan] = None,
                              seed: int = 0,
                              extra: Optional[Dict] = None) -> Dict:
    """Serialize compressed stacks (+ the plan that produced them)."""
    meta = {
        "version": ARTIFACT_VERSION,
        "arch": cfg.name,
        "fingerprint": config_fingerprint(cfg),
        "seed": int(seed),
        "moe_layers": len(stacks_by_layer),
        "plan": None if plan is None else plan.to_json(),
        "extra": extra or {},
    }
    return save_artifact(path, stacks_by_layer, meta=meta)


def _stack_to(stack: CompressedExpertStack, device) -> CompressedExpertStack:
    return dataclasses.replace(
        stack, planes=tuple(p.to(device) for p in stack.planes),
        **{f: getattr(stack, f).to(device)
           for f in ("scale", "zero", "u", "v", "u_scale", "v_scale")},
        _meta={})


def load_compression_artifact(path, cfg: Optional[ModelConfig] = None,
                              strict: bool = True, device=None,
                              shard: Optional[Tuple[int, int]] = None
                              ) -> Tuple[List[Dict], Optional[CompressionPlan],
                                         Dict]:
    """Load ``(stacks_by_layer, plan, manifest-meta)`` with the stacks on
    ``device`` (default: the CUDA device); when ``cfg`` is given the
    stored fingerprint must match (``strict=False`` downgrades a mismatch
    to a manifest flag).

    ``shard=(rank, ep)``: each stack holds only that rank's contiguous
    slice of experts (``distributed.sharding.local_expert_slice``: their
    planes, scales and factors, their true widths and ranks), the slice
    a rank of an ``ep``-way serving mesh serves from; only the slice
    reaches ``device``.  The offload stores meter every expert: load
    with ``device="meta"`` for their metadata alone."""
    if shard is None:
        tree, manifest = load_artifact(path, device)
    else:
        from ..distributed.sharding import local_expert_slice
        tree, manifest = load_artifact(path, "cpu")
        rank, ep = shard
        dev = resolve_device(device)
        tree = [{k: _stack_to(local_expert_slice(
                    s, s.shape[0], rank, ep,
                    prefix=f"layers/{i}/moe/stacks/{k}/"), dev)
                 for k, s in layer.items()}
                for i, layer in enumerate(tree)]
    meta = manifest["meta"]
    if meta.get("version") != ARTIFACT_VERSION:
        raise ValueError(f"artifact version {meta.get('version')} != "
                         f"{ARTIFACT_VERSION}")
    if cfg is not None:
        want = config_fingerprint(cfg)
        if meta["fingerprint"] != want:
            msg = (f"artifact was compressed for {meta['arch']} "
                   f"(fingerprint {meta['fingerprint']}), not "
                   f"{cfg.name} ({want})")
            if strict:
                raise ValueError(msg)
            meta = {**meta, "fingerprint_mismatch": msg}
    stacks_by_layer = list(tree)
    plan = (CompressionPlan.from_json(meta["plan"])
            if meta.get("plan") else None)
    return stacks_by_layer, plan, meta
