"""Sequence packing: concatenate variable-length documents into fixed
(seq_len) rows with segment ids, so no FLOPs are spent on padding (port
of ``repro/data/packing.py``, numpy only: the same packing bit for bit).

``pack_documents`` is greedy first-fit over a document stream; the
returned ``segment_ids`` feed the attention mask (tokens never attend
across document boundaries) and the loss mask (no loss across joints).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


def pack_documents(docs: Iterable[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing.  Returns tokens/segment_ids/mask, each
    (rows, seq_len); segment_ids are 1-based per document, 0 = padding."""
    rows: List[np.ndarray] = []
    segs: List[np.ndarray] = []
    cur = np.full(seq_len, pad_id, np.int32)
    cur_seg = np.zeros(seq_len, np.int32)
    fill = 0
    seg_id = 0
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        while doc.size:
            if fill == seq_len:
                rows.append(cur)
                segs.append(cur_seg)
                cur = np.full(seq_len, pad_id, np.int32)
                cur_seg = np.zeros(seq_len, np.int32)
                fill = 0
            take = min(doc.size, seq_len - fill)
            seg_id += 1
            cur[fill:fill + take] = doc[:take]
            cur_seg[fill:fill + take] = seg_id
            fill += take
            doc = doc[take:]
    if fill:
        rows.append(cur)
        segs.append(cur_seg)
    tokens = np.stack(rows) if rows else np.zeros((0, seq_len), np.int32)
    seg = np.stack(segs) if segs else np.zeros((0, seq_len), np.int32)
    # loss mask: positions whose NEXT token is in the same segment
    mask = np.zeros_like(seg, np.float32)
    mask[:, :-1] = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)
    return {"tokens": tokens, "segment_ids": seg, "mask": mask}


def packing_efficiency(packed: Dict[str, np.ndarray]) -> float:
    seg = packed["segment_ids"]
    return float((seg > 0).mean()) if seg.size else 0.0


def segment_attention_bias(segment_ids: np.ndarray) -> np.ndarray:
    """(B, S) segment ids -> (B, S, S) additive bias blocking cross-doc
    attention (combined with the causal mask downstream)."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    live = (segment_ids > 0)[:, :, None] & (segment_ids > 0)[:, None, :]
    return np.where(same & live, 0.0, -1e30).astype(np.float32)
