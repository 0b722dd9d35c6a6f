"""The distributed verbs of the training loop on `torch.distributed`
(counterpart of `audiocraft_tpu/parallel/distrib.py`, the reference's
`flashy.distrib`).

A process group starts only when it is asked for: by `init`'s arguments,
or by torchrun's `MASTER_ADDR` and `WORLD_SIZE`. Without one every verb is
the one-process case and runs no collective. The group is NCCL when the
run's device is CUDA and gloo on the CPU; host values (metrics, epochs)
travel through it as float64 tensors on that device.
"""
import logging
import os
import typing as tp
import zlib

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)
_INITIALIZED = False


def init(init_method: tp.Optional[str] = None,
         world_size: tp.Optional[int] = None, rank: tp.Optional[int] = None,
         device: tp.Union[str, torch.device, None] = None) -> None:
    """Start the process group if the arguments or torchrun's environment
    ask for one (`init_method` such as `tcp://localhost:<port>`, else
    `env://`). `device` is the run's device (default CUDA): NCCL for CUDA,
    gloo for the CPU. A CUDA rank takes the card `LOCAL_RANK` (default its
    rank modulo the cards)."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return
    from_env = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and not from_env:
        _INITIALIZED = True
        return
    device = torch.device(device or "cuda")
    backend = "nccl" if device.type == "cuda" else "gloo"
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    rank = int(os.environ.get("RANK", 0) if rank is None else rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    logger.info("Process group: %s, rank %d of %d", backend, rank, world_size)
    _INITIALIZED = True


def close() -> None:
    """End the process group (a no-op without one); `init` may start
    another after."""
    global _INITIALIZED
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_distributed() -> bool:
    return world_size() > 1


def is_rank_zero() -> bool:
    return rank() == 0


def comm_device() -> torch.device:
    """Where the group's tensors live: the current card under NCCL, else
    the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Every process reaches this point before any goes on (the sharded
    save's `.tmp.done` protocol relies on it); `name` is for the log."""
    if is_distributed():
        logger.debug("barrier %s", name)
        dist.barrier()


def average_metrics(metrics: tp.Dict[str, tp.Any], count: float = 1.0,
                    weights: tp.Optional[tp.Dict[str, float]] = None
                    ) -> tp.Dict[str, float]:
    """The cross-process weighted mean of host metrics: each key weighted
    by `count`, or by its own entry of `weights`. A process that could not
    produce a metric gives it weight 0; a key whose weight is 0 on every
    process is dropped, identically everywhere. One all-gather of the
    float64 row [crc, value * w..., w...] carries it, the crc of the sorted
    keys making a key set that differs between processes fail loudly. The
    crc is gathered alone first, since rows of different lengths would
    break the collective itself (gloo aborts the process). On one process
    there is no collective."""
    keys = sorted(metrics.keys())
    w = {k: float(count if weights is None else weights.get(k, count))
         for k in keys}
    if not is_distributed():
        return {k: float(metrics[k]) for k in keys if w[k] > 0}
    crc = float(zlib.crc32(";".join(keys).encode()))
    crcs = _all_gather(torch.tensor([crc], dtype=torch.float64))
    assert (crcs[:, 0] == crc).all(), \
        "average_metrics: metric key sets differ across processes — check " \
        "that every process has the same metric checkpoints installed"
    gathered = _all_gather(torch.tensor(
        [crc] + [float(metrics[k]) * w[k] for k in keys]
        + [w[k] for k in keys], dtype=torch.float64))
    total = gathered.sum(axis=0)
    n = len(keys)
    return {k: float(total[1 + i] / total[1 + n + i])
            for i, k in enumerate(keys) if total[1 + n + i] > 0}


def _all_gather(row: torch.Tensor) -> np.ndarray:
    """[world, len] of every process's `row` (same length everywhere)."""
    row = row.to(comm_device())
    rows = [torch.empty_like(row) for _ in range(world_size())]
    dist.all_gather(rows, row)
    return torch.stack(rows).cpu().numpy()


def check_epoch_consistency(epoch: int) -> None:
    """Raise unless every process restored the same epoch: the
    cross-process mean of the epoch must equal our own."""
    if not is_distributed():
        return
    avg = average_metrics({"epoch": float(epoch)})["epoch"]
    if avg != float(epoch):
        raise RuntimeError(
            f"Inconsistent checkpoint restore: our epoch is {epoch} but the "
            f"cross-process average is {avg}; at least one process restored "
            "a different epoch.")


def broadcast_tensors(tensors: tp.Iterable[torch.Tensor], src: int = 0
                      ) -> None:
    """Copy rank `src`'s values into `tensors` on every process, in place.
    The JAX package's counterpart is a no-op, replication being structural
    under GSPMD; here each process holds its own copy."""
    if not is_distributed():
        return
    device = comm_device()
    for tensor in tensors:
        buf = tensor.detach()
        if buf.device != device:
            buf = buf.to(device)
        dist.broadcast(buf, src)
        if buf.device != tensor.device:
            tensor.detach().copy_(buf)


def sync_model(model: torch.nn.Module) -> None:
    """Average the gradients and the float buffers of a replicated model
    over the processes (flashy's `sync_model`, run after backward). The
    JAX package's is a no-op: its gradients come out global."""
    if not is_distributed():
        return
    device = comm_device()
    n = world_size()
    tensors = [p.grad for p in model.parameters() if p.grad is not None]
    tensors += [b for b in model.buffers() if b.is_floating_point()]
    for tensor in tensors:
        buf = tensor.detach().to(device)
        dist.all_reduce(buf)
        tensor.detach().copy_(buf / n)


eager_sync_model = sync_model
