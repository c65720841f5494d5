"""Data: the deterministic synthetic stream and sequence packing (port
of ``repro/data``)."""
