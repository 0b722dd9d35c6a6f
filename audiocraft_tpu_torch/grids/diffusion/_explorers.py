"""Diffusion explorers (`grids/diffusion/_explorers.py`)."""
from .._base_explorers import DiffusionExplorer

__all__ = ["DiffusionExplorer"]
