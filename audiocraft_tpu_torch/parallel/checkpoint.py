"""Sharded checkpoints: each rank writes only its own blocks (counterpart
of `audiocraft_tpu/parallel/checkpoint.py`).

`save_sharded` writes, for every `DTensor` leaf of a state (nested dicts),
this rank's local block with its global index ([ndim, 2] starts and
stops), and every other leaf whole, to `checkpoint[_name].th[.rank]`,
committed by the `.tmp.done` protocol of `utils/checkpoint.py`. Restore
reads the rank's own file and rebuilds each DTensor from its block, so
save and restore must run under the same mesh and placements: a changed
layout raises instead of resharding (as in the JAX package, and unlike
`torch.distributed.checkpoint`).
"""
import typing as tp
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from ..utils.checkpoint import checkpoint_name, load_checkpoint, save_checkpoint


def _flat(tree, prefix: str = "") -> tp.Iterator[tp.Tuple[str, tp.Any]]:
    """(path 'a/b/c', leaf) of nested dicts; anything else is a leaf."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key, value in tree.items():
        yield from _flat(value, f"{prefix}/{key}" if prefix else str(key))


def _local_index(leaf: DTensor) -> tp.Tuple[tp.Tuple[int, int], ...]:
    """(start, stop) per dim of this rank's block of `leaf`."""
    mesh = leaf.device_mesh
    coord = mesh.get_coordinate()
    local = leaf.to_local().shape
    starts = [0] * leaf.ndim
    for m, placement in enumerate(leaf.placements):
        if placement.is_shard():
            starts[placement.dim] += coord[m] * local[placement.dim]
    return tuple((s, s + n) for s, n in zip(starts, local))


def save_sharded(state: tp.Dict[str, tp.Any], directory: tp.Union[str, Path],
                 name: tp.Optional[str] = None) -> Path:
    """Write this rank's blocks of `state` to `checkpoint[_name].th[.rank]`
    with the `.tmp.done` two-phase commit (a collective: every rank
    calls it). Returns this rank's file."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat: tp.Dict[str, tp.Any] = {}
    for key, leaf in _flat(state):
        if isinstance(leaf, DTensor):
            flat[f"{key}::s0"] = leaf.to_local().detach().cpu().clone()
            flat[f"{key}::i0"] = torch.tensor(_local_index(leaf),
                                              dtype=torch.int64)
        elif isinstance(leaf, torch.Tensor):
            flat[key] = leaf.detach().cpu()
        else:
            flat[key] = leaf
    path = directory / checkpoint_name(name, use_fsdp=False)
    save_checkpoint(flat, path, is_sharded=True)
    return path


def restore_sharded(directory: tp.Union[str, Path], template,
                    name: tp.Optional[str] = None):
    """The state saved by `save_sharded`, in `template`'s structure (nested
    dicts whose DTensor leaves give the mesh and placements, e.g. a fresh
    model's and optimizer's state dicts). Raises if the `.tmp.done` token
    is missing (the shard set is incomplete or was never committed), or if
    a block this rank needs is absent (the layout changed)."""
    directory = Path(directory)
    rank0 = directory / checkpoint_name(name, rank=0, use_fsdp=False)
    token = rank0.parent / f"{rank0.name}.tmp.done"
    if not token.exists():
        raise RuntimeError(
            f"sharded checkpoint at {directory} has no {token.name} token: "
            "the shard set is incomplete or was never committed")
    flat = load_checkpoint(directory / checkpoint_name(name, use_fsdp=False))

    def build(node, key: str):
        if isinstance(node, dict):
            return {k: build(v, f"{key}/{k}" if key else str(k))
                    for k, v in node.items()}
        if key in flat:
            value = flat[key]
            if isinstance(node, torch.Tensor) and isinstance(value,
                                                             torch.Tensor):
                return value.to(node.device)
            return value
        blocks = {}
        j = 0
        while f"{key}::i{j}" in flat:
            index = tuple(map(tuple, flat[f"{key}::i{j}"].tolist()))
            blocks[index] = flat[f"{key}::s{j}"]
            j += 1
        if not blocks or not isinstance(node, DTensor):
            raise RuntimeError(f"missing key in sharded checkpoint: {key}")
        index = _local_index(node)
        if index not in blocks:
            raise RuntimeError(
                f"shard {index} of {key} not in this rank's file — restore "
                "must use the save-time mesh layout")
        local = blocks[index].to(node.to_local().device)
        return DTensor.from_local(local, node.device_mesh, node.placements,
                                  run_check=False)

    return build(template, "")
