"""Localised watermark augmentations: `pad` and `mix` (counterpart of
`audiocraft_tpu/modules/watermark.py`).

Each returns the augmented audio and its true predictions [B, 2, T]
(channel 0: not watermarked, channel 1: watermarked), on the audio's
device. The JAX package draws from the global `np.random` and `random`;
here every draw comes from the caller's generator (a CPU
`torch.Generator`; None: torch's default), or is given: `starts` / `ends`
for `pad`, `start_point` / `perm` for `mix`.
"""
import typing as tp

import torch


def _randint(low: int, high: int, size: tp.Tuple[int, ...],
             generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    return torch.randint(low, high, size, generator=generator)


def pad(x_wm: torch.Tensor, central: bool = False,
        generator: tp.Optional[torch.Generator] = None,
        starts: tp.Optional[tp.Sequence[int]] = None,
        ends: tp.Optional[tp.Sequence[int]] = None
        ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Keep the watermark on [start, end) of each row (start below 0.33 T,
    end from 0.66 T), or with `central` everywhere but there; zero the
    rest. Returns (padded, true_predictions)."""
    B, _, T = x_wm.shape
    if starts is None:
        starts = _randint(0, int(0.33 * T), (B,), generator)
    if ends is None:
        ends = _randint(int(0.66 * T), T, (B,), generator)
    mask = torch.zeros(x_wm.shape)
    for i in range(B):
        mask[i, :, int(starts[i]):int(ends[i])] = 1
    if central:
        mask = 1 - mask
    mask = mask.to(x_wm.device, x_wm.dtype)
    return x_wm * mask, torch.cat([1 - mask, mask], dim=1)


def mix(x: torch.Tensor, x_wm: torch.Tensor, window_size: float = 0.5,
        shuffle: bool = False, generator: tp.Optional[torch.Generator] = None,
        start_point: tp.Optional[int] = None,
        perm: tp.Optional[tp.Sequence[int]] = None
        ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Replace a window of `window_size` of the watermarked audio (the same
    window for the batch, its start uniform in [0, T - window]) by the
    clean audio, with `shuffle` another row's. Returns (mixed,
    true_predictions)."""
    assert 0 < window_size <= 1, "window_size should be between 0 and 1"
    T = x.shape[-1]
    window_frames = int(window_size * T)
    if start_point is None:
        start_point = int(_randint(0, T - window_frames + 1, (1,), generator))
    mask = torch.ones(x_wm.shape)
    mask[:, :, start_point:start_point + window_frames] = 0
    mask = mask.to(x_wm.device, x_wm.dtype)
    donor = x
    if shuffle:
        if perm is None:
            perm = torch.randperm(x.shape[0], generator=generator)
        donor = x[torch.as_tensor(perm, device=x.device)]
    mixed = x_wm * mask + donor * (1 - mask)
    return mixed, torch.cat([1 - mask, mask], dim=1)
