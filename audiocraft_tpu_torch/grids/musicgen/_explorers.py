"""MusicGen explorers (`grids/musicgen/_explorers.py`)."""
from .._base_explorers import GenerationEvalExplorer, LMExplorer

__all__ = ["LMExplorer", "GenerationEvalExplorer"]
