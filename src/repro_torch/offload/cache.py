"""Re-export of the device-resident expert LRU (lives with the store)."""
from .store import ExpertCache, FetchStats

__all__ = ["ExpertCache", "FetchStats"]
