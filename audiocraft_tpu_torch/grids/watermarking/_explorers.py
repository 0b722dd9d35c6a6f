"""Watermarking explorers (`grids/watermarking/_explorers.py`)."""
from .._base_explorers import WatermarkingExplorer

__all__ = ["WatermarkingExplorer"]
