"""Compression substrate: packing, HQQ, kurtosis ranks, compensators."""
