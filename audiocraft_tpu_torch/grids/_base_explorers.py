"""Grid (sweep) declarations over the training entry point (counterpart
of `audiocraft_tpu/grids/_base_explorers.py`).

A grid is a pure declaration that enumerates `Job`s: a flat override delta,
the devices it asks for and a stable experiment signature. The CLI
(`python -m audiocraft_tpu_torch.grids <grid>`) prints the plan or runs the
jobs through `audiocraft_tpu_torch.train`.

The fields and their names are the JAX package's, so that every job's
overrides and 8-character signature equal its counterpart's there. On an
H100 host a job's `chips` counts GPUs (its `topology` and the `v5e-*`
labels of the declarations name the TPU slice the JAX package would ask
for, and are kept only as labels); `slurm_(gpus=...)` is an alias of
`tpu_(chips=...)`. Scheduling is left to the host environment: a grid
only emits the job list.
"""
import contextlib
import copy
import typing as tp
from dataclasses import dataclass, field

from ..config import signature


def _flatten(d: tp.Mapping, prefix: str = "") -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


@dataclass
class Job:
    """One sweep point: a flat override delta + the devices it asks for
    (`chips`: GPUs on an H100 host)."""
    overrides: tp.Dict[str, tp.Any]
    chips: int = 8
    topology: tp.Optional[str] = None
    label: tp.Optional[str] = None
    array_id: tp.Optional[int] = None

    @property
    def solver(self) -> tp.Optional[str]:
        return self.overrides.get("solver")

    @property
    def sig(self) -> str:
        return signature(dict(sorted(self.overrides.items())))

    def argv(self) -> tp.List[str]:
        """Arguments for `python -m audiocraft_tpu_torch.train`."""
        return [f"{k}={v if v is not None else 'null'}"
                for k, v in self.overrides.items()]


class Launcher:
    """Collects jobs from a grid body (Dora Launcher equivalent).

    `bind_` mutates this launcher's base overrides; `bind` returns a child
    with copies; calling the launcher submits one job merging the base with
    per-call overrides. `job_array` groups submissions (metadata only — the
    runner decides how to schedule).
    """

    def __init__(self, jobs: tp.Optional[tp.List[Job]] = None,
                 base: tp.Optional[tp.Dict[str, tp.Any]] = None,
                 chips: int = 8, topology: tp.Optional[str] = None,
                 label: tp.Optional[str] = None):
        self._jobs = jobs if jobs is not None else []
        self._base = dict(base or {})
        self._chips = chips
        self._topology = topology
        self._label = label
        self._array: tp.Optional[int] = None
        self._n_arrays = 0

    # --- binding ---------------------------------------------------------
    def _merge(self, args: tp.Sequence[tp.Any], kwargs: tp.Mapping
               ) -> tp.Dict[str, tp.Any]:
        out: tp.Dict[str, tp.Any] = {}
        for a in args:
            if a is None:
                continue
            assert isinstance(a, dict), f"overrides must be dicts, got {a!r}"
            out.update(_flatten(a))
        out.update(_flatten(kwargs))
        return out

    def bind_(self, *args, **kwargs) -> "Launcher":
        self._base.update(self._merge(args, kwargs))
        return self

    def bind(self, *args, **kwargs) -> "Launcher":
        child = Launcher(self._jobs, copy.deepcopy(self._base), self._chips,
                         self._topology, self._label)
        child._array = self._array
        child.bind_(*args, **kwargs)
        return child

    # --- resources -------------------------------------------------------
    def tpu_(self, chips: tp.Optional[int] = None,
             topology: tp.Optional[str] = None, **kwargs) -> "Launcher":
        """The devices of the next jobs: `chips` (GPUs here), a topology
        label and a `label`."""
        if chips is not None:
            self._chips = chips
        if topology is not None:
            self._topology = topology
        if "label" in kwargs:
            self._label = kwargs["label"]
        return self

    def slurm_(self, gpus: tp.Optional[int] = None, **kwargs) -> "Launcher":
        """Upstream's spelling: `gpus` -> `chips`; partition, cpus and
        the other slurm knobs are not kept."""
        return self.tpu_(chips=gpus, label=kwargs.get("label"))

    def tpu(self, **kwargs) -> "Launcher":
        return self.bind().tpu_(**kwargs)

    slurm = tpu

    # --- submission ------------------------------------------------------
    @contextlib.contextmanager
    def job_array(self):
        self._n_arrays += 1
        prev, self._array = self._array, self._n_arrays
        try:
            yield self
        finally:
            self._array = prev

    def __call__(self, *args, **kwargs) -> Job:
        overrides = copy.deepcopy(self._base)
        overrides.update(self._merge(args, kwargs))
        job = Job(overrides=overrides, chips=self._chips,
                  topology=self._topology, label=self._label,
                  array_id=self._array)
        self._jobs.append(job)
        return job

    @property
    def jobs(self) -> tp.List[Job]:
        return self._jobs


class BaseExplorer:
    """Decorator wrapping a grid body (`_base_explorers.py:32-96`).

    Usage mirrors the reference:

        @LMExplorer
        def explorer(launcher):
            launcher.bind_(solver='musicgen/musicgen_base_32khz')
            ...

    `collect()` executes the body and returns the declared jobs.
    """

    # metric table declaration: [(group, [(leaf, fmt), ...]), ...]
    test_metrics: tp.List[tp.Tuple[str, tp.List[tp.Tuple[str, str]]]] = []

    def __init__(self, fn: tp.Callable[[Launcher], None]):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "explorer")
        self.__doc__ = fn.__doc__

    def stages(self) -> tp.List[str]:
        return ["train", "valid", "evaluate"]

    def get_grid_metrics(self):
        """Metric tree for the tracking table (plain tuples; the reference
        uses treetable, which renders the same structure)."""
        return []

    def collect(self) -> tp.List[Job]:
        launcher = Launcher()
        self.fn(launcher)
        return launcher.jobs

    def __call__(self) -> tp.List[Job]:
        return self.collect()


class LMExplorer(BaseExplorer):
    """`grids/musicgen/_explorers.py:14-80`."""

    def stages(self):
        return ["train", "valid"]

    def get_grid_metrics(self):
        return [
            ("train", [("epoch", "d"), ("duration", ".1f"), ("ping", "s"),
                       ("ce", ".4f"), ("ppl", ".3f")]),
            ("valid", [("ce", ".4f"), ("ppl", ".3f"), ("best_ppl", ".3f")]),
        ]


class GenerationEvalExplorer(BaseExplorer):
    """`grids/musicgen/_explorers.py:83-93`."""

    def stages(self):
        return ["evaluate"]

    def get_grid_metrics(self):
        return [
            ("evaluate", [("epoch", "d"), ("duration", ".1f"), ("ping", "s"),
                          ("fad", ".3f"), ("kld", ".3f"), ("text_consistency", ".3f"),
                          ("chroma_cosine", ".3f")]),
        ]


class CompressionExplorer(BaseExplorer):
    """`grids/compression/_explorers.py:12-55`."""

    def stages(self):
        return ["train", "valid", "evaluate"]

    def get_grid_metrics(self):
        return [
            ("train", [("epoch", "d"), ("duration", ".1f"), ("ping", "s")]),
            ("valid", [("bandwidth", ".2f"), ("adv", ".4f"), ("msspec", ".4f"),
                       ("sisnr", ".2f")]),
            ("evaluate", [("sisnr", ".2f"), ("visqol", ".3f"), ("pesq", ".3f")]),
        ]


class DiffusionExplorer(BaseExplorer):
    """`grids/diffusion/_explorers.py:12-56`."""

    def stages(self):
        return ["train", "valid", "valid_ema", "evaluate", "evaluate_ema"]

    def get_grid_metrics(self):
        return [
            ("train", [("epoch", "d"), ("duration", ".1f"), ("ping", "s")]),
            ("valid", [("loss", ".4f")]),
            ("valid_ema", [("loss", ".4f")]),
        ]


class WatermarkingExplorer(BaseExplorer):
    """`grids/watermarking/_explorers.py`."""

    def stages(self):
        return ["train", "valid", "evaluate"]

    def get_grid_metrics(self):
        return [
            ("train", [("epoch", "d"), ("duration", ".1f"),
                       ("d_loss", ".4f"), ("wm_detection_identity", ".4f"),
                       ("wm_mb_identity", ".4f")]),
            ("valid", [("d_loss", ".4f"), ("sisnr", ".2f")]),
        ]
