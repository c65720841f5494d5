"""Command-line entry points: ``compress`` and ``serve``."""
