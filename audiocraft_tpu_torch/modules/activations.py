"""Activation functions (counterpart of `audiocraft_tpu/modules/activations.py`):
exact gelu for the LM; for SEANet any of the names below (ELU by default,
held as an `nn.ELU` module so that its place in the `nn.Sequential`
matches upstream's keys)."""
import functools
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

ActivationFn = tp.Callable[[torch.Tensor], torch.Tensor]


def _glu(gate: ActivationFn, x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * gate(b)


_ACTIVATIONS: tp.Dict[str, ActivationFn] = {
    "relu": F.relu,
    "gelu": F.gelu,
    "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
    "reglu": functools.partial(_glu, F.relu),
    "geglu": functools.partial(_glu, F.gelu),
    "swiglu": functools.partial(_glu, F.silu),
    "glu": functools.partial(_glu, torch.sigmoid),
}


def get_activation_fn(activation: tp.Union[str, ActivationFn],
                      **params) -> ActivationFn:
    """Map a name (any case) to an activation callable. Only `elu` takes
    parameters (`alpha`); the others ignore theirs, as in the JAX
    package."""
    if callable(activation):
        return activation
    name = activation.lower()
    if name == "elu" and params:
        return functools.partial(F.elu, **params)
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {activation!r}")
    return _ACTIVATIONS[name]


class Activation(nn.Module):
    """An activation of `get_activation_fn` as a module without
    parameters: `nn.ELU` for elu, so that state-dict keys stay upstream's."""

    def __new__(cls, activation: str = "elu",
                params: tp.Optional[tp.Mapping[str, tp.Any]] = None):
        if activation.lower() == "elu":
            return nn.ELU(**dict(params or {}))
        return super().__new__(cls)

    def __init__(self, activation: str = "elu",
                 params: tp.Optional[tp.Mapping[str, tp.Any]] = None):
        super().__init__()
        self.name = activation
        self.fn = get_activation_fn(activation, **dict(params or {}))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name
