"""Grid (sweep) declarations (counterpart of `audiocraft_tpu/grids/`).

Each submodule declares an `explorer` (a `BaseExplorer`-decorated function)
that enumerates jobs over config overrides. Inspect or launch with:

    python -m audiocraft_tpu_torch.grids musicgen.musicgen_base_32khz        # plan
    python -m audiocraft_tpu_torch.grids musicgen.musicgen_base_32khz --run  # launch
"""
from ._base_explorers import (BaseExplorer, CompressionExplorer,
                              DiffusionExplorer, GenerationEvalExplorer,
                              Job, Launcher, LMExplorer,
                              WatermarkingExplorer)

__all__ = ["BaseExplorer", "CompressionExplorer", "DiffusionExplorer",
           "GenerationEvalExplorer", "Job", "Launcher", "LMExplorer",
           "WatermarkingExplorer"]
