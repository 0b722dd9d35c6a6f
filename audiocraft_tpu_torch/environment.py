"""The experiment environment: team and cluster settings, where
experiments and reference files live, and the dataset path mappers
(counterpart of `audiocraft_tpu/environment.py`).

A team config is read when `$AUDIOCRAFT_CONFIG` names its YAML file, or
`$AUDIOCRAFT_TEAM` names one under `configs/teams/`; as in the JAX package
(whose default path names no existing file), none is read otherwise. Its
section for the cluster (`$AUDIOCRAFT_CLUSTER`, else guessed: `darwin`,
`gcp`, `rsc` or `local`) may give `dora_dir`, `reference_dir`,
`partitions`, `slurm_exclude` and `dataset_mappers` (regex -> replacement,
applied to every manifest path by the info datasets).

- The experiments' root (a `//sig/<sig>` source names `<root>/xps/<sig>`):
  `$AUDIOCRAFT_DORA_DIR`, else the cluster's `dora_dir`, else
  `audiocraft_tpu_torch` under the temporary directory (`$TMPDIR`).
- What a `//reference/...` path starts with: `$AUDIOCRAFT_REFERENCE_DIR`,
  else the cluster's `reference_dir`, else the temporary directory.
"""
import logging
import os
import re
import socket
import tempfile
import typing as tp
from pathlib import Path

import yaml

logger = logging.getLogger(__name__)

TEAMS_DIR = Path(__file__).resolve().parents[1] / "configs" / "teams"


def _guess_cluster_type() -> str:
    if os.uname().sysname == "Darwin":
        return "darwin"
    if "GCE_METADATA_HOST" in os.environ or os.path.exists("/sys/class/tpu"):
        return "gcp"
    if socket.gethostname().startswith("rsc"):
        return "rsc"
    return "local"


class AudioCraftEnvironment:
    """The team's settings for this cluster, read once per process
    (`reset()` reads them again)."""
    _instance: tp.Optional["AudioCraftEnvironment"] = None
    DEFAULT_TEAM = "default"

    def __init__(self) -> None:
        self.team = os.getenv("AUDIOCRAFT_TEAM", self.DEFAULT_TEAM)
        cluster_type = _guess_cluster_type()
        self.cluster = os.getenv("AUDIOCRAFT_CLUSTER", cluster_type)
        logger.info("Detecting cluster type %s", cluster_type)
        config_path = os.getenv("AUDIOCRAFT_CONFIG") or (
            TEAMS_DIR / f"{self.team}.yaml" if "AUDIOCRAFT_TEAM" in os.environ
            else None)
        self.config: dict = {}
        if config_path is not None and Path(config_path).exists():
            self.config = yaml.safe_load(Path(config_path).read_text()) or {}
        self._dataset_mappers = [
            (re.compile(pattern), repl) for pattern, repl in
            (self._get_cluster_config().get("dataset_mappers") or {}).items()]

    def _get_cluster_config(self) -> dict:
        return self.config.get(self.cluster, {}) or {}

    @classmethod
    def instance(cls) -> "AudioCraftEnvironment":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    @classmethod
    def get_team(cls) -> str:
        return cls.instance().team

    @classmethod
    def get_cluster(cls) -> str:
        return cls.instance().cluster

    @classmethod
    def get_dora_dir(cls) -> Path:
        default = Path(tempfile.gettempdir()) / "audiocraft_tpu_torch"
        return Path(os.getenv(
            "AUDIOCRAFT_DORA_DIR",
            cls.instance()._get_cluster_config().get("dora_dir", default)))

    @classmethod
    def get_reference_dir(cls) -> Path:
        return Path(os.getenv(
            "AUDIOCRAFT_REFERENCE_DIR",
            cls.instance()._get_cluster_config().get(
                "reference_dir", tempfile.gettempdir())))

    @classmethod
    def get_slurm_exclude(cls) -> tp.Optional[str]:
        return cls.instance()._get_cluster_config().get("slurm_exclude")

    @classmethod
    def get_slurm_partitions(cls, partition_types: tp.Optional[
            tp.List[str]] = None) -> str:
        """The cluster's partitions of these types (default 'global'),
        comma-separated."""
        partitions = cls.instance()._get_cluster_config().get(
            "partitions", {}) or {}
        return ",".join(str(partitions.get(t, ""))
                        for t in (partition_types or ["global"]))

    @classmethod
    def resolve_reference_path(cls, path: tp.Union[str, Path]) -> Path:
        """`//reference/x` -> `<reference dir>/x`; other paths as they are."""
        path = str(path)
        if path.startswith("//reference"):
            reference_dir = cls.get_reference_dir()
            if not reference_dir.exists():
                raise FileNotFoundError(f"reference directory {reference_dir} "
                                        f"does not exist")
            path = re.sub("^//reference", str(reference_dir), path)
        return Path(path)

    @classmethod
    def apply_dataset_mappers(cls, path: str) -> str:
        for pattern, repl in cls.instance()._dataset_mappers:
            path = pattern.sub(repl, path)
        return path


def get_dora_dir() -> Path:
    return AudioCraftEnvironment.get_dora_dir()


def get_reference_dir() -> Path:
    return AudioCraftEnvironment.get_reference_dir()


def resolve_reference_path(path: tp.Union[str, Path]) -> Path:
    return AudioCraftEnvironment.resolve_reference_path(path)
