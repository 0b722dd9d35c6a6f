"""Seeded weights for a state dict's shapes, made on the device in one
random draw per call.

The same (shapes, dtype, seed, device) give the same tensors, so the
program is loaded with them and the reference makes them again after the
window, without reading anything of the program. Matrices (every tensor of
two or more axes) are normal with std 1 / sqrt(fan_in) (the product of the
axes after the first); one-axis norm weights and a quantizer's `inited`
flag are ones; every other vector (biases, counts) is zeros.
"""
import math
import typing as tp

import torch

Shapes = tp.Dict[str, tp.Tuple[int, ...]]


def sub_seed(seed: int, stream: int) -> int:
    """A seed for the `stream`-th set of tensors of run `seed`."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63)


def init_rule(name: str, shape: tp.Sequence[int]) -> tp.Union[str, float]:
    """'ones', 'zeros' or the std of a normal draw."""
    if name.endswith("inited"):
        return "ones"
    if len(shape) <= 1:
        leaf = name.rsplit(".", 1)[-1]
        return "ones" if "norm" in name and leaf == "weight" else "zeros"
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(shapes: Shapes, dtype: torch.dtype, seed: int,
                 device) -> tp.Dict[str, torch.Tensor]:
    """Tensors for `shapes`, the drawn ones as views of one flat draw."""
    rules = {n: init_rule(n, s) for n, s in shapes.items()}
    total = sum(math.prod(s) for n, s in shapes.items()
                if isinstance(rules[n], float))
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape in shapes.items():
        rule = rules[name]
        if rule == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif rule == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(rule)
            offset += n
    return out


def shapes_of(module: torch.nn.Module) -> Shapes:
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}
