"""Rotary positional embedding (RoPE) with the optional xPos decay
(counterpart of `audiocraft_tpu/modules/rope.py`).

Feature pairs (2i, 2i + 1) of a head are one complex number, as torch's
`view_as_complex` over [..., D/2, 2] reads them. Positions are a device
tensor, so a decode step rotates at the cache's device offset without
reading it on the host. Keys are rotated once, when they are written to the
cache, and take the inverted xPos decay.
"""
import dataclasses
import typing as tp

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotation of `dim`-wide heads (`dim` / 2 frequencies); `scale` blends
    the rotation with the identity; xPos decays by `smoothing` and
    `base_scale`."""
    dim: int
    max_period: float = 10000.0
    xpos: bool = False
    scale: float = 1.0
    smoothing: float = 0.4
    base_scale: int = 512


def _angles(cfg: RopeConfig, positions: torch.Tensor) -> torch.Tensor:
    """Rotation angles [T, dim / 2] at integer positions [T]."""
    half = torch.arange(cfg.dim // 2, dtype=torch.float32,
                        device=positions.device)
    frequencies = 1.0 / (cfg.max_period ** (2 * half / cfg.dim))
    return positions.float()[:, None] * frequencies[None, :]


def _xpos_decay(cfg: RopeConfig, positions: torch.Tensor) -> torch.Tensor:
    """xPos decay [T, dim / 2]: rate_i ** (position / base_scale)."""
    half = cfg.dim // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    rates = (i / half + cfg.smoothing) / (1.0 + cfg.smoothing)
    return rates[None, :] ** (positions.float()[:, None] / cfg.base_scale)


def rope_rotate(cfg: RopeConfig, x: torch.Tensor, positions: torch.Tensor,
                invert_decay: bool = False) -> torch.Tensor:
    """Rotate x [B, T, H, D] at positions [T], in f32; returns x's dtype.
    Keys pass `invert_decay`: their xPos factor is the reciprocal of the
    queries', so a score decays with the distance between the two."""
    angles = _angles(cfg, positions)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if cfg.xpos:
        decay = _xpos_decay(cfg, positions)
        if invert_decay:
            decay = 1.0 / decay
        cos, sin = cos * decay, sin * decay
    cos = (cos * cfg.scale + (1.0 - cfg.scale))[None, :, None, :]
    sin = (sin * cfg.scale)[None, :, None, :]
    xf = x.float()
    real, imag = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([real * cos - imag * sin, real * sin + imag * cos],
                      dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope_config(positional_embedding: str, head_dim: int, max_period: float,
                xpos: bool, scale: float) -> tp.Optional[RopeConfig]:
    """The rotation of a transformer whose `positional_embedding` is 'rope'
    or 'sin_rope', else None."""
    if positional_embedding not in ("sin", "rope", "sin_rope"):
        raise ValueError(f"unknown positional_embedding "
                         f"{positional_embedding!r}")
    if positional_embedding == "sin":
        return None
    return RopeConfig(dim=head_dim, max_period=max_period, xpos=xpos,
                      scale=scale)
