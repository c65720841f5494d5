"""Optimization: AdamW with f32 master weights, the warmup-cosine
schedule and global-norm clipping (port of ``repro/optim``)."""
from .adamw import (OptState, adamw_init, adamw_update, clip_by_global_norm,
                    global_norm, warmup_cosine)
