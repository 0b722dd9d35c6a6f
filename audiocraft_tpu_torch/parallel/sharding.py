"""Parameter placements over the ('dp', 'fsdp', 'tp') mesh (counterpart of
`audiocraft_tpu/parallel/sharding.py`).

The rules are the JAX package's, keyed by the port's (upstream) parameter
names and written in torch's layout: a linear weight is [out, in] where
flax's kernel is [in, out], so each rule's dims are the JAX rule's
transposed. First match wins:

  * tp: the fused qkv `in_proj_weight` and `linear1` split their output
    rows over tp and their input columns over fsdp; `out_proj` and
    `linear2` the other way round; the per-codebook heads split the
    cardinality over tp (weight and bias).
  * conditioner lookup tables (`nn.Embedding`s) stay replicated.
  * the codebook embeddings split their vocabulary over fsdp.
  * any other parameter of at least 4096 elements is sharded over fsdp on
    its largest divisible dim (ties go to the first dim of flax's layout);
    smaller ones, and the other vectors, stay replicated.

`shard_lm` stores each parameter as a `DTensor` with these placements and
gathers a unit's parameters when the unit runs, as FSDP does: the
forward sees plain full tensors, so every kernel (the causal flash
attention included) gets plain local tensors, and the step computes the
unsharded function. The gather's backward sums the gradient over the
data-like axes and keeps this rank's block. FSDP2's `fully_shard` shards
one dim over one mesh dim, so it cannot hold a rule that puts fsdp and tp
on two dims of one weight; it is not used. The gathered weights live until
the backward has used them, so a rank holds the full parameters during a
step (ZeRO-2's memory, not ZeRO-3's); row- and column-parallel compute on
the local blocks is later work.
"""
import math
import re
import typing as tp

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .mesh import AXES, data_all_reduce, mesh_shape

Spec = tp.Tuple[tp.Optional[str], ...]

# (name regex, axes per torch dim) — first match wins
_TP_RULES: tp.List[tp.Tuple[str, Spec]] = [
    (r"(^|\.)linears\.\d+\.bias$", ("tp",)),
    (r"(^|\.)self_attn\.in_proj_weight$", ("tp", "fsdp")),
    (r"(^|\.)cross_attention\.in_proj_weight$", ("tp", "fsdp")),
    (r"(^|\.)(self_attn|cross_attention)\.out_proj\.weight$", ("fsdp", "tp")),
    (r"(^|\.)linear1\.weight$", ("tp", "fsdp")),
    (r"(^|\.)linear2\.weight$", ("fsdp", "tp")),
    (r"(^|\.)emb\.\d+\.weight$", ("fsdp", None)),
    (r"(^|\.)linears\.\d+\.weight$", ("tp", "fsdp")),
]
# conditioner lookup tables are gather targets: replicated
_CONDITIONER = re.compile(r"(^|\.)condition_provider\.conditioners\.")

_MIN_SHARD_SIZE = 2 ** 12  # below this, replicate


def _fsdp_only_spec(shape: tp.Tuple[int, ...], fsdp: int,
                    transposed: bool) -> Spec:
    """The largest dim divisible by fsdp over fsdp (ties: the first in
    flax's layout, which reverses a linear weight's two dims)."""
    spec: tp.List[tp.Optional[str]] = [None] * len(shape)
    if fsdp == 1 or math.prod(shape) < _MIN_SHARD_SIZE:
        return tuple(spec)
    flax_order = list(range(len(shape)))
    if transposed:
        flax_order.reverse()
    for i in sorted(flax_order, key=lambda i: -shape[i]):
        if shape[i] % fsdp == 0:
            spec[i] = "fsdp"
            break
    return tuple(spec)


def _apply_rule(dims: Spec, shape: tp.Tuple[int, ...],
                sizes: tp.Mapping[str, int]) -> Spec:
    out: tp.List[tp.Optional[str]] = []
    for axis, n in zip(dims, shape):
        size = sizes.get(axis, 1) if axis is not None else 1
        out.append(axis if size > 1 and n % size == 0 else None)
    return tuple(out) + (None,) * (len(shape) - len(out))


def infer_param_spec(name: str, shape: tp.Sequence[int],
                     sizes: tp.Mapping[str, int], kind: str = "other"
                     ) -> Spec:
    """The mesh axis of each dim of parameter `name` (None: replicated)
    on a mesh of `sizes` ({'dp': n, 'fsdp': n, 'tp': n}). `kind` is
    'linear' for a weight stored [out, in] (flax: [in, out]), 'embedding'
    for an `nn.Embedding` table, else 'other'."""
    shape = tuple(shape)
    if kind == "embedding" and _CONDITIONER.search(name):
        return (None,) * len(shape)
    for pattern, dims in _TP_RULES:
        if re.search(pattern, name):
            return _apply_rule(dims, shape, sizes)
    if len(shape) <= 1:
        return (None,) * len(shape)
    return _fsdp_only_spec(shape, sizes.get("fsdp", 1), kind == "linear")


def placements(spec: Spec) -> tp.List[tp.Union[Shard, Replicate]]:
    """DTensor placements over (dp, fsdp, tp) of a spec."""
    out: tp.List[tp.Union[Shard, Replicate]] = []
    for axis in AXES:
        dims = [d for d, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _kind(module: nn.Module, name: str) -> str:
    if name == "in_proj_weight" or (name == "weight"
                                    and isinstance(module, nn.Linear)):
        return "linear"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "other"


def _local_block(full: torch.Tensor, param: DTensor) -> torch.Tensor:
    """This rank's block of `full` under `param`'s placements."""
    mesh = param.device_mesh
    coord = mesh.get_coordinate()
    block = full
    for m, placement in enumerate(param.placements):
        if isinstance(placement, Shard):
            block = block.chunk(mesh.size(m), dim=placement.dim)[coord[m]]
    return block


class _GatherAtUse(torch.autograd.Function):
    """local block -> the full parameter (a plain tensor); the gradient
    is summed over the data-like axes and cut back to the local block."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, param: DTensor) -> torch.Tensor:
        ctx.param = param
        if all(p.is_replicate() for p in param.placements):
            return local.view_as(local)
        return DTensor.from_local(local, param.device_mesh, param.placements,
                                  run_check=False).full_tensor()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        param = ctx.param
        grad = data_all_reduce(grad.contiguous(), param.device_mesh)
        return _local_block(grad, param).contiguous(), None


def _gather(param: DTensor) -> torch.Tensor:
    return _GatherAtUse.apply(param.to_local(), param)


def _gather_hook(unit: nn.Module, args) -> None:
    for owner, name in unit._gathered_at_use:
        owner.__dict__[name] = _gather(owner._parameters[name])


def _release_hook(unit: nn.Module, args, output) -> None:
    for owner, name in unit._gathered_at_use:
        owner.__dict__.pop(name, None)


def _units(model: nn.Module) -> tp.Dict[nn.Module, tp.List[tp.Tuple[nn.Module,
                                                                     str]]]:
    """The gather units of an LM, as FSDP wraps them: each transformer
    layer, each conditioner (a T5 encoder reads its position table
    outside that table's module) and the LM for the rest (the codebook
    embeddings and heads, the output norm, the fuser); each parameter
    (owner, name) goes to the innermost unit around it."""
    from ..modules.conditioners import BaseConditioner
    from ..modules.transformer import StreamingTransformerLayer
    units: tp.Dict[nn.Module, tp.List[tp.Tuple[nn.Module, str]]] = {}
    seen: tp.Set[int] = set()

    def visit(module: nn.Module, unit: nn.Module) -> None:
        if id(module) in seen:
            return
        seen.add(id(module))
        if isinstance(module, (StreamingTransformerLayer, BaseConditioner)):
            unit = module
        for name, _ in module.named_parameters(recurse=False):
            units.setdefault(unit, []).append((module, name))
        for child in module.children():
            visit(child, unit)

    visit(model, model)
    return units


def shard_lm(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Store every parameter of `model` (on the mesh's device) as a
    DTensor with the rules' placements, rank 0's values everywhere, and
    gather a unit's parameters while the unit runs (`_units`; the plain
    tensors go in each owner's instance dict, found before its parameter
    table). Build the optimizer after this. Returns `model`."""
    sizes = mesh_shape(mesh)
    for prefix, module in model.named_modules():
        for name, param in list(module.named_parameters(recurse=False)):
            full_name = f"{prefix}.{name}" if prefix else name
            spec = infer_param_spec(full_name, param.shape, sizes,
                                    _kind(module, name))
            stored = distribute_tensor(param.detach(), mesh,
                                       placements(spec))
            module._parameters[name] = nn.Parameter(
                stored, requires_grad=param.requires_grad)
    for unit, params in _units(model).items():
        unit._gathered_at_use = tuple(params)
        unit.register_forward_pre_hook(_gather_hook)
        unit.register_forward_hook(_release_hook, always_call=True)
    return model


def is_sharded(tensors: tp.Iterable[torch.Tensor]) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


@torch.no_grad()
def clip_grad_norm_(grads: tp.Sequence[torch.Tensor], max_norm: float
                    ) -> torch.Tensor:
    """The global norm of DTensor gradients (each block counted once,
    however many ranks hold it), and their scaling by max_norm / (norm +
    1e-6) where that is below 1 (torch's clip; 0: no clipping). Returns
    the norm before clipping, a 0-d tensor on the gradients' device."""
    locals_ = [g.to_local() for g in grads]
    norms = torch._foreach_norm(locals_)
    repl = [math.prod(g.device_mesh.size(m)
                      for m, p in enumerate(g.placements) if p.is_replicate())
            for g in grads]
    sq = sum(n.float().square() / r for n, r in zip(norms, repl))
    if dist.get_world_size() > 1:
        dist.all_reduce(sq)
    norm = sq.sqrt()
    if max_norm:
        coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
        torch._foreach_mul_(locals_, coef)
    return norm
