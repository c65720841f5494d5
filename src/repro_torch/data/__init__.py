"""Synthetic calibration data (port of ``repro/data``)."""
