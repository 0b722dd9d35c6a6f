"""Compression explorers (`grids/compression/_explorers.py`)."""
from .._base_explorers import CompressionExplorer

__all__ = ["CompressionExplorer"]
