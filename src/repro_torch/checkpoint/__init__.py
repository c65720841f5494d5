"""Checkpointing: the structure-carrying artifact codec
(``artifact.py``) and the training ``CheckpointManager`` built on it
(``manager.py``)."""
