"""Trace the first updates of training with `torch.profiler` (counterpart
of `audiocraft_tpu/utils/profiler.py`, which traces with `jax.profiler`).

With `enabled`, entering the context starts a trace of the host and, where
there is a card, of its kernels; after `num_steps` calls of `step()` (or on
exit, if sooner) the trace is written to `output_dir` as a Chrome trace
(`trace_<steps>.json`, readable in Perfetto or chrome://tracing). Only the
first `num_steps` updates are ever traced: entering again after that does
nothing, so a solver can wrap every split. The program's spans
(`utils.tracing`: `solver.step`, `solver.forward`, ...) are on while it
records and show in the trace under their names.
"""
import logging
import typing as tp
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


class Profiler:
    def __init__(self, enabled: bool = False,
                 output_dir: tp.Union[str, Path] = "profile",
                 num_steps: int = 20):
        self.enabled = enabled
        self.output_dir = Path(output_dir)
        self.num_steps = num_steps
        self._step = 0
        self._prof: tp.Optional[torch.profiler.profile] = None

    def step(self) -> None:
        """Call once per training update."""
        if not self.enabled:
            return
        self._step += 1
        if self._prof is not None and self._step >= self.num_steps:
            self._stop()

    def _stop(self) -> None:
        self._prof.stop()
        path = self.output_dir / f"trace_{self._step}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        logger.info("Profiler trace written to %s", path)

    def __enter__(self):
        if self.enabled and self._step < self.num_steps and self._prof is None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            logger.info("Profiler on for the first %d updates", self.num_steps)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._prof is not None:
            self._stop()
