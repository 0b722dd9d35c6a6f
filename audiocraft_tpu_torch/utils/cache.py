"""Disk caches (counterpart of `audiocraft_tpu/utils/cache.py`).

`EmbeddingCache` keeps one embedding per source file (a conditioner's
chroma or style features) on disk, named by the SHA-1 of the file's path,
as a pickled numpy array, and loads a batch's with a thread pool.

`CachedBatchWriter` / `CachedBatchLoader` store and replay a solver's
precomputed batches (MusicGen: the codec's codes, the tokenized
conditions and the padding mask): one zip per batch,
`<folder>/<epoch:05d>/<index:06d>.zip`, holding the pickled tuple of what
the solver saved under the name `content`. Tensors are written as numpy
arrays, the layout the JAX package writes, so each package reads the
other's cache.
"""
import hashlib
import logging
import pickle
import typing as tp
import zipfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def to_numpy_tree(tree):
    """Every tensor of dicts, lists, tuples and named tuples as numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree


def get_full_embed(full_embed, x: tp.Any, idx: int):
    """The default extraction: the whole cached embedding."""
    return full_embed


class EmbeddingCache:
    """Embeddings of files, computed by `compute_embed_fn(path, x, idx)` on a
    miss and saved under `cache_path`; `extract_embed_fn(full_embed, x,
    idx)` takes what a batch item needs from a file's embedding (default:
    all of it). Call `populate_embed_cache(paths, x)` before
    `get_embed_from_cache(paths, x)` to load the batch's cached ones in
    parallel."""

    def __init__(self, cache_path: tp.Union[str, Path],
                 compute_embed_fn: tp.Callable[[Path, tp.Any, int], tp.Any],
                 extract_embed_fn: tp.Optional[tp.Callable] = None):
        self.cache_path = Path(cache_path)
        self._compute_embed_fn = compute_embed_fn
        self._extract_embed_fn = (extract_embed_fn
                                  or partial(get_full_embed, idx=0))
        self.cache_path.mkdir(exist_ok=True, parents=True)
        logger.info(f"Cache instantiated at: {self.cache_path}")
        self.pool = ThreadPoolExecutor(8)
        self._current_batch_cache: dict = {}
        self._memory_cache: dict = {}

    def _get_cache_path(self, path: tp.Union[Path, str]) -> Path:
        return self.cache_path / hashlib.sha1(str(path).encode()).hexdigest()

    @staticmethod
    def _get_full_embed_from_cache(cache: Path):
        with open(cache, "rb") as f:
            return pickle.load(f)

    def get_embed_from_cache(self, paths: tp.List[Path], x: tp.Any
                             ) -> np.ndarray:
        """The embeddings of a batch, stacked: loaded by the last
        `populate_embed_cache`, or computed now and saved."""
        embeds = []
        for idx, path in enumerate(paths):
            cache = self._get_cache_path(path)
            if cache in self._current_batch_cache:
                embed = self._current_batch_cache[cache]
            else:
                full = np.asarray(to_numpy_tree(
                    self._compute_embed_fn(path, x, idx)))
                try:
                    with open(cache, "wb") as f:
                        pickle.dump(full, f)
                except Exception as exc:
                    logger.error("Error saving embed %s (%s): %r", cache,
                                 full.shape, exc)
                else:
                    logger.info("New embed cache saved: %s (%s)", cache,
                                full.shape)
                embed = self._extract_embed_fn(full, x, idx)
            embeds.append(np.asarray(to_numpy_tree(embed)))
        return np.stack(embeds)

    def populate_embed_cache(self, paths: tp.List[Path], x: tp.Any) -> None:
        """Load the cached embeddings of a batch's files in parallel."""
        self._current_batch_cache.clear()
        futures = []
        for path in paths:
            assert path is not None, "Path is required for computation from cache"
            cache = self._get_cache_path(path)
            futures.append(None if cache in self._memory_cache
                           or not cache.exists() else
                           self.pool.submit(self._get_full_embed_from_cache,
                                            cache))
        for idx, (path, future) in enumerate(zip(paths, futures)):
            if future is None:
                continue
            cache = self._get_cache_path(path)
            try:
                full = future.result()
            except Exception as exc:
                logger.error("Error loading %s: %r", cache, exc)
            else:
                self._current_batch_cache[cache] = self._extract_embed_fn(
                    full, x, idx)


def _zip_path(folder: Path, epoch: int, index: int) -> Path:
    return Path(folder) / f"{epoch:05d}" / f"{index:06d}.zip"


class CachedBatchWriter:
    """Writes one zip per batch of an epoch (rank 0 only)."""

    def __init__(self, cache_folder: Path):
        self.cache_folder = Path(cache_folder)
        self._current_epoch: tp.Optional[int] = None
        self._current_index = 0

    def start_epoch(self, epoch: int) -> None:
        self._current_epoch = epoch
        self._current_index = 0
        self._zip_path.parent.mkdir(exist_ok=True, parents=True)

    @staticmethod
    def _get_zip_path(cache_folder: Path, epoch: int, index: int) -> Path:
        return _zip_path(cache_folder, epoch, index)

    @property
    def _zip_path(self) -> Path:
        assert self._current_epoch is not None
        return _zip_path(self.cache_folder, self._current_epoch,
                         self._current_index)

    def save(self, *content) -> None:
        """Store the batch's `content` (tensors as numpy) as the next zip."""
        from .checkpoint import current_rank
        if current_rank() == 0:
            path = self._zip_path
            path.parent.mkdir(exist_ok=True, parents=True)
            with zipfile.ZipFile(path, "w") as zf:
                with zf.open("content", "w") as f:
                    pickle.dump(to_numpy_tree(content), f)
        self._current_index += 1


class CachedBatchLoader:
    """Iterates an epoch's cached batches in order, `num_workers` threads
    reading ahead; it ends at the first missing zip (which must not come
    before `min_length`). `set_epoch` / `start_epoch` picks the epoch."""

    def __init__(self, cache_folder: Path, batch_size: int,
                 num_workers: int = 10, min_length: int = 1):
        self.cache_folder = Path(cache_folder)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.min_length = min_length
        self._current_epoch: tp.Optional[int] = None
        self.sampler = None

    def __len__(self) -> int:
        folder = _zip_path(self.cache_folder, self._current_epoch or 0,
                           0).parent
        return sum(1 for p in folder.iterdir() if p.suffix == ".zip")

    def start_epoch(self, epoch: int) -> None:
        self._current_epoch = epoch

    set_epoch = start_epoch

    def _load_one(self, index: int):
        assert self._current_epoch is not None
        path = _zip_path(self.cache_folder, self._current_epoch, index)
        if not path.exists():
            if index < self.min_length:
                raise RuntimeError(f"Cache should have at least "
                                   f"{self.min_length} batches, but {index} "
                                   f"doesn't exist")
            return None
        try:
            with zipfile.ZipFile(path, "r") as zf:
                with zf.open("content", "r") as f:
                    return pickle.load(f)
        except Exception:
            logger.error("Error when reading zip path %s", path)
            raise

    def __iter__(self):
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque(pool.submit(self._load_one, i)
                                   for i in range(2 * self.num_workers))
            next_index = len(pending)
            while True:
                batch = pending.popleft().result()
                if batch is None:
                    return
                pending.append(pool.submit(self._load_one, next_index))
                next_index += 1
                yield batch
