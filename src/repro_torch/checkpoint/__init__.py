"""The artifact codec (``artifact.py``); training checkpoints are not
ported."""
