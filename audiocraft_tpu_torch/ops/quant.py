"""W8A8 int8 serving quantization for the LM's decode path (counterpart of
`audiocraft_tpu/ops/quant.py`).

Weights are quantized per output channel (symmetric, scale = max|w| / 127
with the max floored at 1e-8 first), activations per row on the fly; the
product accumulates int8 x int8 in int32 (`torch._int_mm`) and is rescaled as
f32 * x_scale * w_scale before the cast. Rounding is half to even on both
sides, so the int8 values, the scales and the int32 sums equal the JAX
package's bit for bit.

Weights keep PyTorch's Linear layout [d_out, d_in]; `QTensor` stands in for
such a weight (or a stack of them), and `qdot` dispatches on it, so the same
call serves the plain and the quantized model.
"""
import dataclasses
import typing as tp

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA takes only more than 16 rows, and inner and output
# widths that are multiples of 8
_CUDA_MIN_ROWS = 17


def div_scalar(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d rounded once, on every device. Given a Python number, a CUDA
    division multiplies by the reciprocal instead, which can land one ulp
    away from the CPU's (and the JAX package's) quotient."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


@dataclasses.dataclass
class QTensor:
    """Per-output-channel symmetric int8 weight and its dequant scale.

    w: int8 [..., d_out, d_in]; scale: f32 [..., d_out]; dtype: the dtype of
    the weight it replaces (the compute dtype of its layer). Indexing selects
    output channels of weight and scale alike (the fused qkv's row slices)."""
    w: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.w[idx], self.scale[idx], self.dtype)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Per-output-channel int8 quantization of w [..., d_out, d_in] (d_in is
    reduced); an all-zero row quantizes to zeros, not NaN."""
    w32 = w.float()
    s = div_scalar(w32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    return QTensor(torch.round(w32 / s).to(torch.int8), s[..., 0], w.dtype)


def quantize_acts(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization: (x_int8, f32 scale
    [..., 1])."""
    x32 = x.float()
    xs = div_scalar(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(x32 / xs).to(torch.int8), xs


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 product a [M, K] @ b [K, N] -> int32 [M, N]. On CUDA the
    rows are zero-padded to the 17 that `torch._int_mm` needs (CFG decode at
    batch 1 has 2) and the pad sliced off; K and N must be multiples of 8."""
    M = a.shape[0]
    if a.device.type == "cuda":
        if a.shape[1] % 8 or b.shape[1] % 8:
            raise ValueError(f"int8 product needs widths that are multiples "
                             f"of 8 on CUDA, got {a.shape[1]} x {b.shape[1]}")
        if M < _CUDA_MIN_ROWS:
            a = F.pad(a, (0, 0, 0, _CUDA_MIN_ROWS - M))
    return torch._int_mm(a, b)[:M]


def w8a8_dot(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [..., d_in] @ int8 weight [d_out, d_in]^T -> [..., d_out] in x's
    dtype."""
    xq, xs = quantize_acts(x)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), qt.w.t())
    out = acc.float() * xs.reshape(-1, 1) * qt.scale
    return out.to(x.dtype).reshape(*x.shape[:-1], qt.w.shape[0])


def qdot(x: torch.Tensor, w: tp.Union[torch.Tensor, QTensor],
         bias: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """`F.linear(x, w, bias)` with QTensor dispatch. A plain weight keeps
    F.linear's math; a QTensor goes through `w8a8_dot` in x's dtype and the
    bias is added after the rescale (the JAX package's `QDense`)."""
    if isinstance(w, QTensor):
        y = w8a8_dot(x, w)
        return y if bias is None else y + bias.to(y.dtype)
    return F.linear(x, w, bias)


def w8a8_heads(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Per-codebook output heads: x [B, S, D] x int8 [K, C, D] -> [B, K, S, C]
    in x's dtype, with one activation quantization shared by the K heads."""
    B, S, D = x.shape
    K, C, _ = qt.w.shape
    xq, xs = quantize_acts(x)
    acc = int_mm(xq.reshape(B * S, D), qt.w.reshape(K * C, D).t())
    out = acc.float().reshape(B, S, K, C) * xs[..., None] * qt.scale
    return out.permute(0, 2, 1, 3).to(x.dtype)
