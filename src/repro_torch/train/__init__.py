"""Training: the fault-tolerant loop (checkpoint and resume, failure
injection, straggler monitor) and gradient accumulation (port of
``repro/train``)."""
from .loop import FailureInjector, StragglerMonitor, TrainResult, train
