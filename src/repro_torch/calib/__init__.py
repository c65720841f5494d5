"""Offline calibration and heterogeneous precision allocation (port of
``repro/calib``): ``stats`` (routing and activation statistics from a
calibration corpus), ``allocate`` (per-expert bits and per-(projection,
expert) ranks under a wire-byte budget) and ``artifact`` (the plan and
compressed stacks on disk, so serving boots without recompressing);
``launch/compress.py`` chains them."""
from .stats import (LayerCalibStats, collect_calibration_stats,
                    stats_summary)
from .allocate import (SCORERS, CompressionPlan, LayerAllocation,
                       allocate_budget, moe_weights_by_layer,
                       plan_wire_bytes, stacks_wire_bytes, uniform_plan,
                       weighted_restoration_error)
from .artifact import (config_fingerprint, load_compression_artifact,
                       save_compression_artifact)
