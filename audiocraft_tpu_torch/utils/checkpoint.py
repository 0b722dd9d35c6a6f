"""Checkpoint naming, source resolution, atomic saves with the sharded
`.tmp.done` protocol, and the stale flush (counterpart of
`audiocraft_tpu/utils/checkpoint.py`).

The port's checkpoints are `torch.save` files of plain containers and
tensors, read back with `weights_only=True`. A checkpoint that the JAX
package's `save_checkpoint` wrote (an npz of flattened `a/b/c` paths) is
recognised by its members and read with numpy (`load_jax_params`), so its
weights can be carried into the port (`utils/jax_weights.py`).
"""
import logging
import os
import re
import typing as tp
import zipfile
from pathlib import Path

import numpy as np
import torch

from .. import environment
from ..parallel import distrib

logger = logging.getLogger(__name__)


def current_rank() -> int:
    return distrib.rank()


def checkpoint_name(name: tp.Optional[str] = None,
                    rank: tp.Optional[int] = None,
                    use_fsdp: bool = False) -> str:
    """`checkpoint[_<name>].th`, with `.<rank>` for ranks above 0 or for
    sharded (FSDP) checkpoints."""
    rank = current_rank() if rank is None else rank
    suffix = f".{rank}" if rank > 0 or use_fsdp else ""
    name_part = f"_{name}" if name is not None else ""
    return f"checkpoint{name_part}.th{suffix}"


def is_sharded_checkpoint(path: Path) -> bool:
    return re.search(r"\.th\.\d+$", Path(path).name) is not None


def resolve_checkpoint_path(sig_or_path: tp.Union[Path, str],
                            name: tp.Optional[str] = None,
                            use_fsdp: bool = False) -> tp.Optional[Path]:
    """The checkpoint file of `//sig/<sig>` (an experiment under the dora
    directory), of a directory, or a file path; None if it does not
    exist."""
    path = environment.resolve_reference_path(sig_or_path)
    if str(sig_or_path).startswith("//sig/"):
        path = environment.get_dora_dir() / "xps" / str(sig_or_path)[6:]
    if path.is_dir():
        path = path / checkpoint_name(name, use_fsdp=use_fsdp)
    return path if path.exists() else None


def save_checkpoint(state: tp.Dict[str, tp.Any],
                    path: tp.Union[Path, str], is_sharded: bool = False
                    ) -> None:
    """`torch.save` to `<path>.tmp`, then an atomic rename onto `path`, so
    a reader never sees half a file. A sharded save (every rank writes its
    own `path`) is a two-phase commit: rank 0 removes the stale
    `.tmp.done` token beside rank 0's file, all ranks meet, each writes,
    all meet again, and only then rank 0 touches the token; a reader that
    sees it has a complete shard set."""
    path = Path(path)
    token = None
    if is_sharded:
        stem = re.sub(r"^checkpoint_?|\.th.*$", "", path.name) or None
        rank0 = path.parent / checkpoint_name(stem, rank=0, use_fsdp=False)
        token = rank0.parent / f"{rank0.name}.tmp.done"
        if distrib.is_rank_zero() and token.exists():
            token.unlink()
        distrib.barrier("ckpt-token-removed")
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    if token is not None:
        distrib.barrier("ckpt-shards-written")
        if distrib.is_rank_zero():
            token.touch()


def load_checkpoint(path: tp.Union[Path, str]) -> tp.Dict[str, tp.Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def is_jax_checkpoint(path: tp.Union[Path, str]) -> bool:
    """True for an npz of the JAX package (every member a `.npy`); a
    `torch.save` file is a zip too, with a `data.pkl` member."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as archive:
        names = archive.namelist()
    return bool(names) and all(n.endswith(".npy") for n in names)


class _Node(dict):
    """A nested dict whose keys also read as attributes, as the JAX
    package's dataclass nodes (e.g. RVQ `codebooks.embed`) are read."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None


def unflatten(flat: tp.Mapping[str, np.ndarray]) -> _Node:
    """Flattened `a/b/c` arrays (the JAX package's npz layout) as nested
    `_Node`s."""
    tree = _Node()
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, _Node())
        node[parts[-1]] = value
    return tree


def load_jax_params(path: tp.Union[Path, str]) -> _Node:
    """The `params` of a JAX training state saved by the JAX package's
    `save_checkpoint` (keys `params/<collection>/...`), as nested dicts of
    numpy arrays; the step and the optimizer state are left out. A state
    without `params` (the codec trainer's, whose weights sit under
    `gen_vars/` and `adv_states/`) comes whole."""
    with np.load(path, allow_pickle=False) as data:
        flat = {key: data[key] for key in data.files}
    if not any(key.startswith("params/") for key in flat):
        return unflatten(flat)
    return unflatten({key[len("params/"):]: value
                      for key, value in flat.items()
                      if key.startswith("params/")})


def flush_stale_checkpoints(checkpoint_path: Path, keep_last: int = 0) -> None:
    """Keep only the `keep_last` latest `checkpoint_<epoch>.th` files of
    this rank beside `checkpoint_path` (0: keep all)."""
    if keep_last <= 0:
        return
    rank = current_rank()
    suffix = f".{rank}" if rank > 0 else ""
    epochs = []
    for path in Path(checkpoint_path).parent.glob(f"checkpoint_*.th{suffix}"):
        epoch = path.name.split(".", 1)[0].split("_", 1)[1]
        if epoch.isdigit():
            epochs.append((int(epoch), path))
    for _, path in sorted(epochs)[:max(0, len(epochs) - keep_last)]:
        logger.debug("Removing checkpoint: %s", path)
        path.unlink(missing_ok=True)
