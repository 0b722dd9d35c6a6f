"""Activation functions (counterpart of `audiocraft_tpu/modules/activations.py`):
exact gelu for the LM, elu for SEANet (which holds it as an `nn.ELU` module,
so that its place in the `nn.Sequential` matches upstream's keys)."""
import typing as tp

import torch
import torch.nn.functional as F

ActivationFn = tp.Callable[[torch.Tensor], torch.Tensor]

_ACTIVATIONS: tp.Dict[str, ActivationFn] = {"gelu": F.gelu, "elu": F.elu}


def get_activation_fn(activation: tp.Union[str, ActivationFn]) -> ActivationFn:
    """Map a name to an activation callable."""
    if callable(activation):
        return activation
    name = activation.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {activation!r}")
    return _ACTIVATIONS[name]
