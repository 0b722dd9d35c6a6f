"""The ('dp', 'fsdp', 'tp') device mesh on `torch.distributed`
(counterpart of `audiocraft_tpu/parallel/mesh.py`).

One rank per device: data parallel ('dp', replicas), parameter sharding
('fsdp', ZeRO style) and tensor parallel ('tp'). The batch is split over
the two data-like axes; ranks that differ only in 'tp' take the same rows.
"""
import typing as tp

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import distrib

AXES = ("dp", "fsdp", "tp")


def create_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1,
                world_size: tp.Optional[int] = None) -> DeviceMesh:
    """A ('dp', 'fsdp', 'tp') `DeviceMesh` over the process group's ranks
    (`world_size` of them, default the group's). One axis may be -1
    (inferred); the mesh must cover the world. CUDA under NCCL, else the
    CPU."""
    n = distrib.world_size() if world_size is None else world_size
    sizes = {"dp": dp, "fsdp": fsdp, "tp": tp}
    unknown = [k for k, v in sizes.items() if v == -1]
    assert len(unknown) <= 1, "at most one mesh axis may be -1"
    known = int(np.prod([v for v in sizes.values() if v != -1]))
    if unknown:
        assert n % known == 0, (n, sizes)
        sizes[unknown[0]] = n // known
    total = sizes["dp"] * sizes["fsdp"] * sizes["tp"]
    assert total == n, f"mesh {sizes} does not cover {n} devices"
    device_type = distrib.comm_device().type
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> tp.Dict[str, int]:
    """{'dp': n, 'fsdp': n, 'tp': n} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class _BatchSlice:
    """Dim 0 of every tensor or array in a (nested) dict, tuple or list,
    cut to the rows of data index `index` of `count`."""

    def __init__(self, index: int, count: int):
        self.index, self.count = index, count

    def __call__(self, tree):
        if isinstance(tree, dict):
            return {k: self(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self(v) for v in tree)
        if getattr(tree, "ndim", 0) == 0 or self.count == 1:
            return tree
        rows = tree.shape[0]
        assert rows % self.count == 0, \
            f"batch of {rows} rows does not split over {self.count} ranks"
        step = rows // self.count
        return tree[self.index * step:(self.index + 1) * step]


def batch_sharding(mesh: DeviceMesh) -> _BatchSlice:
    """This rank's slice of a global batch: rows split over ('dp',
    'fsdp'), the same rows on every 'tp' rank."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    return _BatchSlice(coord["dp"] * shape["fsdp"] + coord["fsdp"],
                       shape["dp"] * shape["fsdp"])


def replicated(mesh: DeviceMesh) -> _BatchSlice:
    """The whole of every leaf on every rank."""
    return _BatchSlice(0, 1)


def constrain_batch(tree, mesh: tp.Optional[DeviceMesh]):
    """The input unchanged. The JAX package pins activations to the batch
    sharding here to steer XLA's partitioner away from a full
    rematerialisation; a rank here holds plain local activations, so
    there is nothing to steer."""
    return tree


def data_size(mesh: DeviceMesh) -> int:
    """How many ranks split the batch: dp x fsdp."""
    shape = mesh_shape(mesh)
    return shape["dp"] * shape["fsdp"]


def _data_axes(mesh: DeviceMesh) -> tp.List[str]:
    # fsdp first: the data index is dp-major (`batch_sharding`)
    return [a for a in ("fsdp", "dp") if mesh.size(AXES.index(a)) > 1]


def data_all_reduce(tensor: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """`tensor` summed, in place, over the ranks that share this rank's tp
    coordinate (those that split the batch)."""
    for axis in _data_axes(mesh):
        dist.all_reduce(tensor, group=mesh.get_group(axis))
    return tensor


def data_all_gather(tensor: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data rank's `tensor` concatenated on dim 0 in data-index
    order: the rows of the global batch where each rank holds its slice
    (`batch_sharding`)."""
    for axis in _data_axes(mesh):
        group = mesh.get_group(axis)
        parts = [torch.empty_like(tensor)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, tensor.contiguous(), group=group)
        tensor = torch.cat(parts)
    return tensor


@torch.no_grad()
def data_average_grads(params: tp.Iterable[torch.Tensor],
                       mesh: DeviceMesh) -> None:
    """Average each gradient over the data ranks (replicated parameters
    whose loss is a mean over each rank's slice of the batch)."""
    n = data_size(mesh)
    for p in params:
        if p.grad is not None and n > 1:
            data_all_reduce(p.grad, mesh).div_(n)
