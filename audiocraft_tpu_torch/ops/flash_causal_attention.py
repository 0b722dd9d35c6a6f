"""Causal self-attention over full sequences, forward and backward.

Counterpart of `audiocraft_tpu/ops/attention.py::flash_causal_attention`,
which reaches the Pallas TPU flash-attention kernel (a forward plus a
custom-VJP backward). On CUDA tensors `flash_causal_attention` runs the
hand-written Hopper kernels of `csrc/flash_causal_attention.cu` inside a
`torch.autograd.Function` (see the source header for the design: it is bound
by tensor-core operations); on CPU tensors it computes the same function with
`flash_causal_attention_reference`, whose gradient autograd derives. There is
no other route.

Layouts: q, k, v [B, T, H, D], float32 or bfloat16, the last dimension
contiguous; other strides are read as they are, so the chunks of a fused qkv
projection go in without a copy. Returns [B, T, H, D] in q's dtype. The
TPU wrapper padded T to a multiple of 128; the kernel masks its ragged last
tile instead.
"""
import ctypes
import math

import torch

from . import _build
from .attention import FLASH_CAUSAL_HEAD_DIMS as _HEAD_DIMS
from .attention import make_causal_bias

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launchers: dict = {}


def flash_causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 scores with the causal bias of
    `make_causal_bias`, f32 softmax and products, output in q's dtype."""
    _check_shapes(q, k, v)
    T, D = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(D)),
                          k.float())
    pos = torch.arange(T, device=q.device)
    w = torch.softmax(logits + make_causal_bias(pos, pos), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def _check_shapes(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one shape [B, T, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _check_cuda(q, k, v):
    _check_shapes(q, k, v)
    D = q.shape[-1]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}, got {D}")
    vec = 16 // q.element_size()  # elements per 16-byte load
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % vec for s in t.stride()[:3]):
            raise ValueError("flash_causal_attention needs the head dim "
                             "contiguous and 16-byte aligned rows")


def _launcher(name: str, n_pointers: int):
    fn = _launchers.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_causal_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


def _strides(*tensors) -> ctypes.Array:
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash_causal_attention {what} launch failed: CUDA "
                           f"error {err}")


def _forward(q, k, v):
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    err = _launcher("flash_causal_fwd_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, H, D, _DTYPE_CODES[q.dtype], _strides(q, k, v, out),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "forward")
    flash_causal_attention.launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout):
    B, T, H, D = q.shape
    dout = dout.to(q.dtype).contiguous()
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(dout) for _ in range(3))
    err = _launcher("flash_causal_bwd_launch", 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, H, D, _DTYPE_CODES[q.dtype],
        _strides(q, k, v, dout), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "backward")
    flash_causal_attention.backward_launches += 1
    return dq, dk, dv


class _FlashCausalAttention(torch.autograd.Function):
    """Forward kernel saving the per-row log-sum-exp; backward kernels
    (delta pre-pass, dK/dV, dQ) recomputing the probabilities from it."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _backward(*ctx.saved_tensors, dout)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D) + causal mask).v over q, k, v [B, T, H, D].

    CPU tensors take `flash_causal_attention_reference`; CUDA tensors launch
    the kernels on the current stream (no synchronisation) or raise.
    `flash_causal_attention.launches` counts forward launches and
    `.backward_launches` backward ones (three kernels each)."""
    if q.device.type == "cpu":
        return flash_causal_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_causal_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda(q, k, v)
    return _FlashCausalAttention.apply(q, k, v)


flash_causal_attention.launches = 0
flash_causal_attention.backward_launches = 0
