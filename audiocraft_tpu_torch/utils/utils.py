"""Device selection, hashing, masks and token sampling
(counterpart of `audiocraft_tpu/utils/utils.py`)."""
import hashlib
import typing as tp

import numpy as np
import torch


def resolve_device(device: tp.Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back to
    the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_module_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless every parameter and buffer of `module` is on `device`."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.device != device:
            raise ValueError(f"{type(module).__name__} holds tensors on "
                             f"{t.device}, not {device}: move it first")


def randn(shape: tp.Sequence[int], generator: tp.Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """Standard normal f32 draws of `shape` on `device`: the Gaussian noise
    of the diffusion and flow-matching samplers, which their modules call
    by this name so that a test can replace it."""
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def find_local_checkpoint(env_var: str, names: tp.Sequence[str]):
    """A local checkpoint: the path in `$<env_var>` when it exists, else the
    first of `names` under `$AUDIOCRAFT_CACHE_DIR`; None without either."""
    import os
    from pathlib import Path
    cand = os.environ.get(env_var)
    if cand and Path(cand).exists():
        return Path(cand)
    cache = os.environ.get("AUDIOCRAFT_CACHE_DIR")
    if cache:
        for name in names:
            path = Path(cache) / name
            if path.exists():
                return path
    return None


def hash_trick(word: str, vocab_size: int) -> int:
    """Hash a word into a fixed vocab (sha256, as the JAX package)."""
    digest = int(hashlib.sha256(word.encode("utf-8")).hexdigest(), 16)
    return digest % vocab_size


def length_to_mask(lengths: np.ndarray, max_len: tp.Optional[int] = None
                   ) -> np.ndarray:
    """[B] lengths -> [B, max_len] int32 mask (at least one column)."""
    lengths = np.asarray(lengths)
    assert lengths.ndim == 1
    final_length = int(lengths.max()) if max_len is None else max_len
    final_length = max(final_length, 1)
    return (np.arange(final_length)[None, :] < lengths[:, None]).astype(np.int32)


def _categorical(logits: torch.Tensor,
                 generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """One index per row of f32 logits [..., C] by the Gumbel-max trick:
    device-only, no host synchronisation."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1, keepdim=True)


def multinomial(probs: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample one index per row of probs [..., C] -> [..., 1]."""
    return _categorical(torch.log(probs.clamp_min(1e-20)), generator)


def sample_top_k(probs: torch.Tensor, k: int,
                 generator: tp.Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Top-k sampling (k clamped to the vocabulary) -> indices [..., 1]."""
    top_probs, top_idx = torch.topk(probs, min(k, probs.shape[-1]), dim=-1)
    return torch.gather(top_idx, -1, multinomial(top_probs, generator))


def sample_top_p(probs: torch.Tensor, p: float,
                 generator: tp.Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Nucleus sampling: drop tokens once the mass before them exceeds p."""
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    kept = sorted_probs.masked_fill((cum - sorted_probs) > p, 0.0)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    return torch.gather(sorted_idx, -1, multinomial(kept, generator))


def sample_tokens(logits: torch.Tensor, *, use_sampling: bool = True,
                  temp: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                  generator: tp.Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Greedy / temperature / top-k / top-p sampling on logits [..., C].
    Returns indices [..., 1]."""
    if use_sampling and temp > 0.0:
        probs = torch.softmax(logits.float() / temp, dim=-1)
        if top_p > 0.0:
            return sample_top_p(probs, top_p, generator)
        if top_k > 0:
            return sample_top_k(probs, top_k, generator)
        return multinomial(probs, generator)
    return torch.argmax(logits, dim=-1, keepdim=True)


_WARNED: tp.Set[str] = set()


def warn_once(logger, msg: str) -> None:
    """Log `msg` as a warning the first time only."""
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger.warning(msg)


def construct_frame_chords(min_timestamp: int,
                           chord_changes: tp.List[tp.Tuple[float, str]],
                           mapping_dict: tp.Dict[str, int], prev_chord: str,
                           frame_rate: float,
                           segment_duration: float) -> tp.List[int]:
    """The chord index of each frame from `min_timestamp` (a frame number)
    for `segment_duration` seconds: the chord in force at the frame's time,
    from `prev_chord` on through the sorted (time, chord) changes; no chord
    ('' or None) is 'N'."""
    changes = list(chord_changes)
    current = prev_chord
    out = []
    for frame in range(min_timestamp,
                       int(min_timestamp + segment_duration * frame_rate)):
        t = frame / frame_rate
        while changes and t >= changes[0][0]:
            current = changes.pop(0)[1]
        current = "N" if current in (None, "") else current
        out.append(mapping_dict[current])
    return out


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; a host tensor goes to a card through page-locked
    memory without blocking the host (the copy is ordered on the current
    stream before the kernels that read it)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device == device:
        return t.to(device)
    if t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
