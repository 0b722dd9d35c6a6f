"""Exponential moving average of named tensors (counterpart of
`audiocraft_tpu/optim/ema.py`).

The shadow starts at zeros and is read out unbiased: divided by
1 - decay ** count. Tensors that are not floating point (step counters,
`inited` flags) are copied as they are. The shadow is updated in place.
"""
import dataclasses
import typing as tp

import torch

Named = tp.Mapping[str, torch.Tensor]


@dataclasses.dataclass
class EMAState:
    shadow: tp.Dict[str, torch.Tensor]
    count: torch.Tensor  # 0-d float32, the updates taken


def ema_init(named: Named) -> EMAState:
    shadow = {k: torch.zeros_like(v).detach() for k, v in named.items()}
    device = next(iter(shadow.values())).device if shadow else None
    return EMAState(shadow, torch.zeros((), device=device))


def ema_update(state: EMAState, named: Named, decay: float = 0.999
               ) -> EMAState:
    """shadow <- shadow * decay + value * (1 - decay) for float tensors;
    a copy of the value otherwise."""
    with torch.no_grad():
        for key, value in named.items():
            s = state.shadow[key]
            if s.is_floating_point():
                s.mul_(decay).add_(value.to(s.dtype) * (1 - decay))
            else:
                s.copy_(value)
        state.count += 1
    return state


def ema_params(state: EMAState, decay: float = 0.999
               ) -> tp.Dict[str, torch.Tensor]:
    """The unbiased averages: shadow / (1 - decay ** max(count, 1))."""
    w = 1 - decay ** state.count.clamp_min(1)
    return {k: s / w.to(s.dtype) if s.is_floating_point() else s.clone()
            for k, s in state.shadow.items()}
