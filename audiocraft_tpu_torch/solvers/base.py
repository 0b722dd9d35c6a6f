"""The run loop shared by the solvers (the part of
`audiocraft_tpu/solvers/base.py::SolverRunMixin` that training one stage
needs). Writers, the profiler, the deadlock watchdog, checkpoints and EMA are
not ported yet (ROADMAP, slice E)."""
import logging
import time
import typing as tp

logger = logging.getLogger(__name__)


class SolverRunMixin:
    """Iterates a split's loader through the solver's `run_step` and
    averages the step metrics. A loader is any iterable of batches in
    `self.dataloaders[split]`."""
    cfg: tp.Dict[str, tp.Any]
    dataloaders: tp.Dict[str, tp.Iterable]
    epoch: int = 1

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        raise NotImplementedError()

    def _iter_split(self, split: str, max_updates: int) -> dict:
        loader = self.dataloaders.get(split)
        if loader is None:
            return {}
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.epoch)
        average: tp.Dict[str, float] = {}
        count = 0
        log_every = (self.cfg.get("logging", {}) or {}).get("log_updates", 10)
        begin = time.time()
        for idx, batch in enumerate(loader):
            if max_updates and idx >= max_updates:
                break
            metrics = self.run_step(idx, batch, {})
            count += 1
            for key, value in metrics.items():
                average[key] = average.get(key, 0.0) + float(value)
            if log_every and (idx + 1) % log_every == 0:
                speed = (idx + 1) / (time.time() - begin)
                short = {k: round(average[k] / count, 4)
                         for k in list(average)[:6]}
                logger.info("%s epoch %d [%d] %.2f it/s %s", split,
                            self.epoch, idx + 1, speed, short)
        return {k: v / max(count, 1) for k, v in average.items()}

    def run_one_stage(self, stage_name: str) -> dict:
        """Run one stage over its split and return the averaged metrics.
        'train' and 'valid' iterate their loaders; 'evaluate' and
        'generate' are not ported yet (ROADMAP, slice E)."""
        if stage_name in ("evaluate", "generate"):
            raise NotImplementedError(f"the {stage_name!r} stage is not "
                                      f"ported (ROADMAP, slice E)")
        updates = (self.cfg.get("optim", {}) or {}).get("updates_per_epoch",
                                                        0) or 0
        return self._iter_split(stage_name, updates)
