"""Batches of a dataset over `torch.utils.data.DataLoader` (counterpart of
`audiocraft_tpu/data/loader.py`).

A batch is `batch_size` consecutive indices of the dataset's order (index
order, or a seeded shuffle per epoch), collated by the dataset's
`collater`; an incomplete last batch is dropped unless `drop_last` is
False. With `num_workers` > 0 the batches are made in that many worker
processes (each with one torch thread: torch's CPU thread teams spin, and
many of them on one host slow everything down) and come back through
shared memory, `pin_memory` ones in page-locked memory for a non-blocking
copy to the card. Workers fork from a fresh server process (the
`forkserver` start method), not from the caller; each imports the
caller's main module, so a script that iterates a loader with workers
keeps its work under `if __name__ == "__main__":` (and is a file, not
standard input). A dataset item is a pure
function of its index and the epoch, so the batches do not depend on the
number of workers.
`set_epoch(epoch)` calls the dataset's `start_epoch`; workers are started
anew for each pass, so they see the epoch.
`shutdown()` ends the workers still running, the fork server and the
resource tracker, and waits for them; it runs at exit too, so no process
of the loader outlives its caller (the fork server, which imports torch,
would otherwise take about a second to wind down after the caller has
gone).
"""
import atexit
import gc
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import typing as tp

import numpy as np
import torch
import torch.utils.data


def _one_thread(worker_id: int) -> None:
    torch.set_num_threads(1)


def _worker_context():
    """Workers fork from a server process started afresh (with this package
    and torch imported once), never from the caller, whose threads (CUDA's,
    a profiler's, JAX's in the tests) a fork would copy mid-state."""
    global _SHUTDOWN_AT_EXIT
    if not _SHUTDOWN_AT_EXIT:
        atexit.register(shutdown)
        _SHUTDOWN_AT_EXIT = True
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


_SHUTDOWN_AT_EXIT = False


def shutdown() -> None:
    """End the worker processes still running (a pass left unfinished),
    then the fork server and multiprocessing's resource tracker, and wait
    for each. A later loader with workers starts them again."""
    children = multiprocessing.active_children()
    for child in children:
        if child.daemon:
            child.terminate()
    for child in children:
        child.join()
    gc.collect()  # finalise the queues of the passes that have ended
    # each `_stop` closes the helper's "alive" pipe and reaps it (the fork
    # server first: it holds the tracker's pipe too); multiprocessing has no
    # public call for either
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


class _BatchOrder(torch.utils.data.Sampler):
    """The index lists of the loader's batches, in order."""

    def __init__(self, loader: "DataLoader"):
        self.loader = loader

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        order = self.loader.index_order()
        size = self.loader.batch_size
        for start in range(0, len(order), size):
            batch = order[start:start + size]
            if len(batch) == size or not self.loader.drop_last:
                yield [int(i) for i in batch]


class DataLoader:
    """Iterate `dataset` in batches; see the module's docstring.
    `timeout` (seconds, 0: none) bounds the wait for a worker's batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = True,
                 collate_fn: tp.Optional[tp.Callable] = None,
                 prefetch: int = 2, seed: int = 0, pin_memory: bool = False,
                 timeout: float = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate_fn = (collate_fn or getattr(dataset, "collater", None)
                           or torch.stack)
        self.prefetch = prefetch
        self.seed = seed
        self.pin_memory = pin_memory
        self.timeout = timeout
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "start_epoch"):
            self.dataset.start_epoch(epoch)

    def __len__(self) -> int:
        n, rest = divmod(len(self.dataset), self.batch_size)
        return n + (1 if rest and not self.drop_last else 0)

    def index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self):
        workers = max(self.num_workers, 0)
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=_BatchOrder(self),
            collate_fn=self.collate_fn, num_workers=workers,
            pin_memory=self.pin_memory,
            worker_init_fn=_one_thread if workers else None,
            multiprocessing_context=_worker_context() if workers else None,
            prefetch_factor=self.prefetch if workers else None,
            timeout=self.timeout if workers else 0)
        return iter(loader)
