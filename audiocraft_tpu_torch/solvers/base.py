"""The run loop shared by the solvers (counterpart of
`audiocraft_tpu/solvers/base.py`).

`SolverRunMixin` is the loop of the concrete LM solvers: iterate a split's
loader through `run_step` under the profiler and the deadlock watchdog,
average the metrics, run the stages of an epoch, write the metrics and the
checkpoint, and restore. `StandardSolver` adds the abstract builders, an
EMA of the model's weights swapped in for validation, and the best state.

A checkpoint is `checkpoint.th` in the experiment folder (`cfg['folder']`,
default `<dora dir>/xps/default`): the solver's `state_dict()` through
`torch.save`, beside a JSON sidecar with the epoch and the history. On
`restore` the run's own checkpoint wins over `continue_from`: a run
restarted with the same config resumes its own progress. `continue_from`
(a path, a folder or `//sig/<sig>`) is a warm start: the model's weights
only, and the epoch count starts again. It may also name a checkpoint of
the JAX package, whose parameters are carried over by name
(`load_jax_params`).
"""
import abc
import contextlib
import copy
import json
import logging
import time
import typing as tp
from pathlib import Path

import torch

from .. import environment
from ..optim.ema import EMAState, ema_init, ema_params, ema_update
from ..parallel import distrib
from ..utils import checkpoint

logger = logging.getLogger(__name__)


def _jsonable(metrics: tp.Any) -> tp.Any:
    if isinstance(metrics, dict):
        return {k: _jsonable(v) for k, v in metrics.items()}
    if isinstance(metrics, (list, tuple)):
        return [_jsonable(v) for v in metrics]
    if isinstance(metrics, torch.Tensor):
        return metrics.item() if metrics.numel() == 1 else metrics.tolist()
    return metrics


class SolverRunMixin:
    """Epochs over the loaders in `self.dataloaders` (any iterables of
    batches) through the solver's `run_step`. A solver provides
    `state_dict()`, `load_state_dict(state)` and `load_model_weights(state)`
    (a warm start) for its checkpoints, and `load_jax_params(tree)` to take
    the weights of a JAX checkpoint."""
    cfg: tp.Dict[str, tp.Any]
    dataloaders: tp.Dict[str, tp.Iterable]
    epoch: int = 1
    current_stage: str = "train"  # the split `_iter_split` is running

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        raise NotImplementedError()

    @property
    def _folder(self) -> Path:
        folder = Path(self.cfg.get("folder")
                      or environment.get_dora_dir() / "xps" / "default")
        folder.mkdir(parents=True, exist_ok=True)
        return folder

    @property
    def writers(self):
        if not hasattr(self, "_writers"):
            from ..utils.writers import ExperimentWriters
            self._writers = ExperimentWriters(self.cfg, self._folder)
        return self._writers

    def _aux_tools(self):
        """The profiler and the deadlock watchdog of `cfg['profiler']` and
        `cfg['deadlock']`, made once."""
        if not hasattr(self, "_profiler"):
            from ..utils.deadlock import DeadlockDetect
            from ..utils.profiler import Profiler
            pcfg = self.cfg.get("profiler", {}) or {}
            dcfg = self.cfg.get("deadlock", {}) or {}
            self._profiler = Profiler(
                enabled=pcfg.get("enabled", False),
                output_dir=pcfg.get("output_dir") or self._folder / "profile",
                num_steps=pcfg.get("num_steps", 20))
            self._deadlock = DeadlockDetect(use=dcfg.get("use", False),
                                            timeout=dcfg.get("timeout", 600))
        return self._profiler, self._deadlock

    def _step_done(self, split: str, idx: int) -> None:
        """Called after each step of a split (the EMA of `StandardSolver`)."""

    def _iter_split(self, split: str, max_updates: int) -> dict:
        """Run the split's loader (at most `max_updates` batches; 0: all)
        and return the metrics averaged over its steps ({} without a
        loader)."""
        loader = self.dataloaders.get(split)
        if loader is None:
            return {}
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.epoch)
        profiler, deadlock = self._aux_tools()
        self.current_stage = split
        try:
            return self._run_loader(loader, split, max_updates, profiler,
                                    deadlock)
        finally:
            self.current_stage = "train"

    def _run_loader(self, loader, split, max_updates, profiler,
                    deadlock) -> dict:
        average: tp.Dict[str, float] = {}
        count = 0
        log_every = (self.cfg.get("logging", {}) or {}).get("log_updates", 10)
        begin = time.time()
        with profiler, deadlock:
            for idx, batch in enumerate(loader):
                if max_updates and idx >= max_updates:
                    break
                deadlock.update("batch")
                metrics = self.run_step(idx, batch, {})
                deadlock.update("step")
                self._step_done(split, idx)
                if split == "train":
                    profiler.step()
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

    @property
    def history(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """Per-epoch metrics, kept in the checkpoint's sidecar."""
        if not hasattr(self, "_history"):
            self._history: tp.List[tp.Dict[str, tp.Any]] = []
        return self._history

    def checkpoint_path(self, name: tp.Optional[str] = None) -> Path:
        return self._folder / checkpoint.checkpoint_name(name)

    def save_checkpoints(self) -> None:
        """The solver's state and the sidecar (rank 0 only)."""
        if checkpoint.current_rank() != 0:
            return
        path = self.checkpoint_path()
        checkpoint.save_checkpoint(self.state_dict(), path)
        sidecar = Path(str(path) + ".json")
        tmp = sidecar.with_name(sidecar.name + ".tmp")
        tmp.write_text(json.dumps({"epoch": self.epoch,
                                   "history": _jsonable(self.history)}))
        tmp.replace(sidecar)
        logger.info("Checkpoint saved to %s", path)

    def restore(self, continue_from: tp.Optional[str] = None) -> bool:
        """Resume from the run's own checkpoint, else warm-start from
        `continue_from`; False when there is neither."""
        path: tp.Optional[Path] = self.checkpoint_path()
        own = path.exists()
        if not own:
            if continue_from is None:
                return False
            path = checkpoint.resolve_checkpoint_path(continue_from)
            if path is None:
                raise FileNotFoundError(f"no checkpoint at {continue_from}")
        if checkpoint.is_jax_checkpoint(path):
            self.load_jax_params(checkpoint.load_jax_params(path))
        elif own:
            self.load_state_dict(checkpoint.load_checkpoint(path))
        else:
            self.load_model_weights(checkpoint.load_checkpoint(path))
        sidecar = Path(str(path) + ".json")
        if own and sidecar.exists():
            extra = json.loads(sidecar.read_text())
            self.epoch = extra.get("epoch", 1)
            self._history = extra.get("history", [])
        elif not own:
            # a warm start: `run` advances the epoch after a restore, so
            # the new run trains its whole schedule from epoch 1
            self.epoch = 0
        logger.info("Restored from %s (epoch %d)", path, self.epoch)
        return True

    def should_run_stage(self, stage: str) -> bool:
        """On the last epoch, or every `cfg[stage]['every']` epochs."""
        is_last = self.epoch == (self.cfg.get("optim", {}) or {}).get(
            "epochs", 1)
        every = (self.cfg.get(stage, {}) or {}).get("every")
        return is_last or (every is not None and self.epoch % every == 0)

    def evaluate(self) -> dict:
        return {}

    def generate(self) -> dict:
        return {}

    def _epoch_stages(self) -> dict:
        """One epoch: train, valid when there is a loader, then evaluate
        and generate when `should_run_stage` says so."""
        updates = (self.cfg.get("optim", {}) or {}).get("updates_per_epoch",
                                                        0) or 0
        metrics = {"train": self._iter_split("train", updates)}
        if "valid" in self.dataloaders:
            metrics["valid"] = self._iter_split("valid", 0)
        if self.should_run_stage("evaluate"):
            metrics["evaluate"] = self.evaluate()
        if self.should_run_stage("generate"):
            metrics["generate"] = self.generate()
        return metrics

    def run(self) -> tp.List[dict]:
        """Restore, then run epochs up to `optim.epochs`, writing the
        metrics and a checkpoint after each; with `execute_only` run that
        one stage instead. Returns this run's metrics per epoch."""
        if self.restore(self.cfg.get("continue_from")):
            self.epoch += 1
        distrib.check_epoch_consistency(self.epoch)
        execute_only = self.cfg.get("execute_only")
        if execute_only:
            logger.info("Running single stage: %s", execute_only)
            return [{execute_only: self.run_one_stage(execute_only)}]
        epochs = (self.cfg.get("optim", {}) or {}).get("epochs", 1)
        history = []
        while self.epoch <= epochs:
            logger.info("Starting epoch %d...", self.epoch)
            metrics = self._epoch_stages()
            for stage, stage_metrics in metrics.items():
                self.writers.write_scalars(stage, stage_metrics, self.epoch)
            history.append(metrics)
            self.history.append(_jsonable(metrics))
            self.save_checkpoints()
            self.epoch += 1
        logger.info("Training done.")
        return history

    def run_one_stage(self, stage_name: str) -> dict:
        """One stage: 'evaluate', 'generate', or a split's loader ('train'
        up to `optim.updates_per_epoch` batches)."""
        if stage_name == "evaluate":
            return self.evaluate()
        if stage_name == "generate":
            return self.generate()
        updates = (self.cfg.get("optim", {}) or {}).get("updates_per_epoch",
                                                        0) or 0
        return self._iter_split(stage_name, updates)


class StandardSolver(SolverRunMixin, abc.ABC):
    """A solver over one `nn.Module` (`self.model`) and its optimizer
    (`self.optimizer`, a `torch.optim.Optimizer`), built by the subclass in
    `build_model`, with loaders from `build_dataloaders`.

    With `optim.ema.use`, an EMA of the model's state dict (decay
    `optim.ema.decay`, updated every `optim.ema.updates` train steps)
    replaces the weights during validation (`swap_ema`). The best state is
    the weights (the EMA's when it is on) of the epoch with the lowest
    `best_metric_name` in validation (or training without a valid loader),
    or the latest when the solver names no metric."""

    def __init__(self, cfg: dict, device=None):
        from ..utils.utils import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        self.epoch = 1
        self.dataloaders: tp.Dict[str, tp.Iterable] = {}
        ema_cfg = (cfg.get("optim", {}) or {}).get("ema", {}) or {}
        self.ema_use = bool(ema_cfg.get("use", False))
        self.ema_decay = float(ema_cfg.get("decay", 0.99))
        self.ema_every = int(ema_cfg.get("updates", 1))
        self.ema_state: tp.Optional[EMAState] = None
        self.best_state: tp.Optional[tp.Dict[str, torch.Tensor]] = None
        self._best_metric_value: tp.Optional[float] = None
        self.model: torch.nn.Module
        self.optimizer: torch.optim.Optimizer
        self.build_dataloaders()
        self.build_model()

    @abc.abstractmethod
    def build_model(self) -> None:
        """Set `self.model` and `self.optimizer`."""

    @abc.abstractmethod
    def build_dataloaders(self) -> None:
        """Fill `self.dataloaders`."""

    @property
    def best_metric_name(self) -> tp.Optional[str]:
        return None

    def _ema_source(self) -> tp.Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def init_ema(self) -> None:
        if self.ema_use and self.ema_state is None:
            self.ema_state = ema_init(self._ema_source())
            logger.info("EMA of the model with decay %.4f every %d updates",
                        self.ema_decay, self.ema_every)

    def _step_done(self, split: str, idx: int) -> None:
        if (split == "train" and self.ema_state is not None
                and (idx + 1) % self.ema_every == 0):
            ema_update(self.ema_state, self._ema_source(), self.ema_decay)

    @contextlib.contextmanager
    def swap_ema(self):
        """The model holds the EMA's weights inside the context (once the
        EMA has taken a step), its own weights again after."""
        if self.ema_state is None or float(self.ema_state.count) == 0:
            yield
            return
        saved = copy.deepcopy(self.model.state_dict())
        self.model.load_state_dict(ema_params(self.ema_state, self.ema_decay))
        try:
            yield
        finally:
            self.model.load_state_dict(saved)

    def update_best_state(self, stage_metrics: dict) -> None:
        name = self.best_metric_name
        with self.swap_ema():
            weights = copy.deepcopy(self.model.state_dict())
        if name is None or name not in stage_metrics:
            self.best_state = weights
            return
        value = float(stage_metrics[name])
        if self._best_metric_value is None or value < self._best_metric_value:
            self._best_metric_value = value
            self.best_state = weights
            logger.info("New best state with %s=%.4f", name, value)

    def _epoch_stages(self) -> dict:
        updates = (self.cfg.get("optim", {}) or {}).get("updates_per_epoch",
                                                        0) or 0
        metrics = {"train": self._iter_split("train", updates)}
        if "valid" in self.dataloaders:
            with self.swap_ema():
                metrics["valid"] = self._iter_split("valid", 0)
            self.update_best_state(metrics["valid"])
        else:
            self.update_best_state(metrics["train"])
        if self.should_run_stage("evaluate"):
            metrics["evaluate"] = self.evaluate()
        if self.should_run_stage("generate"):
            metrics["generate"] = self.generate()
        return metrics

    def run(self) -> tp.List[dict]:
        self.init_ema()
        return super().run()

    def run_one_stage(self, stage_name: str) -> dict:
        self.init_ema()
        if stage_name == "valid":
            with self.swap_ema():
                return super().run_one_stage(stage_name)
        return super().run_one_stage(stage_name)

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        """Everything a resumed run needs: the weights, the optimizer, the
        EMA and the best state with its metric."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "best_metric_value": self._best_metric_value}
        if self.ema_state is not None:
            state["ema"] = {"shadow": self.ema_state.shadow,
                            "count": self.ema_state.count}
        if self.best_state is not None:
            state["best_state"] = self.best_state
        return state

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._best_metric_value = state.get("best_metric_value")
        if "ema" in state:
            self.ema_state = EMAState(
                {k: v.to(self.device) for k, v in state["ema"]["shadow"].items()},
                state["ema"]["count"].to(self.device))
        self.best_state = state.get("best_state")

    def load_model_weights(self, state: tp.Dict[str, tp.Any]) -> None:
        self.model.load_state_dict(state["model"])

    def load_jax_params(self, tree) -> None:
        raise NotImplementedError(f"{type(self).__name__} has no map of the "
                                  f"JAX package's parameters")
