"""Causal self-attention over full sequences, forward and backward.

Counterpart of `audiocraft_tpu/ops/attention.py::flash_causal_attention`,
which reaches the Pallas TPU flash-attention kernel (a forward plus a
custom-VJP backward). The function is two `torch.library` ops that the
dispatcher sees, so that selective activation checkpointing can save their
outputs (`modules/transformer.py`, `checkpointing='dots'|'dots_nb'`):

- `audiocraft_tpu_torch::flash_causal_fwd(q, k, v) -> (out, lse)`;
- `audiocraft_tpu_torch::flash_causal_bwd(q, k, v, out, lse, dout)
  -> (dq, dk, dv)`,

joined by `register_autograd`. On CUDA tensors they run the hand-written
Hopper kernels of `csrc/flash_causal_attention.cu` (see the source header
for the design: it is bound by tensor-core operations); on CPU tensors the
plain versions `flash_causal_attention_reference` and
`flash_causal_attention_backward_reference`, which compute the same math
in f32. There is no other route: another device raises.

Layouts: q, k, v [B, T, H, D], float32 or bfloat16, the last dimension
contiguous; other strides are read as they are, so the chunks of a fused qkv
projection go in without a copy. out [B, T, H, D] in q's dtype, contiguous;
lse [B, H, T] f32, the natural log-sum-exp of each row's scaled scores. The
TPU wrapper padded T to a multiple of 128; the kernel masks its ragged last
tile instead.
"""
import ctypes
import math
import typing as tp

import torch

from . import _build
from .attention import FLASH_CAUSAL_HEAD_DIMS as _HEAD_DIMS
from .attention import make_causal_bias

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launchers: dict = {}


def _scaled_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 q.k^T / sqrt(D) plus the causal bias: [B, H, T, T]."""
    T, D = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(D)),
                          k.float())
    pos = torch.arange(T, device=q.device)
    return logits + make_causal_bias(pos, pos)


def flash_causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor
                                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: f32 scores with the causal bias of
    `make_causal_bias`, f32 softmax and products. Returns (out [B, T, H, D]
    in q's dtype, lse [B, H, T] f32), both contiguous, as the kernel."""
    _check_shapes(q, k, v)
    scores = _scaled_scores(q, k)
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype).contiguous(), lse.contiguous()


def flash_causal_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward, the kernels' math in f32: P = exp(S - lse),
    delta = rowsum(dO * O), dV = P^T dO, dS = P * (dO V^T - delta),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D). Returns (dq, dk, dv)
    [B, T, H, D] in q's dtype, contiguous."""
    scale = 1.0 / math.sqrt(q.shape[3])
    p = torch.exp(_scaled_scores(q, k) - lse[..., None])       # [B, H, T, T]
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)          # [B, H, T]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v.float()) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return tuple(t.to(q.dtype).contiguous() for t in (dq, dk, dv))


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
    """The forward kernel on the current stream: (out, lse)."""
    _check_cuda(q, k, v)
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
    """The delta pre-pass, dK/dV and dQ kernels: (dq, dk, dv)."""
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


@torch.library.custom_op("audiocraft_tpu_torch::flash_causal_fwd",
                         mutates_args=(), device_types="cpu")
def flash_causal_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    # the plain version in f32 whatever autocast asks of the ops inside
    with torch.autocast("cpu", enabled=False):
        return flash_causal_attention_reference(q, k, v)


@torch.library.custom_op("audiocraft_tpu_torch::flash_causal_bwd",
                         mutates_args=(), device_types="cpu")
def flash_causal_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    with torch.autocast("cpu", enabled=False):
        return flash_causal_attention_backward_reference(q, k, v, out, lse,
                                                         dout)


flash_causal_fwd.register_kernel("cuda")(_forward)
flash_causal_bwd.register_kernel("cuda")(_backward)


@flash_causal_fwd.register_fake
def _(q, k, v):
    B, T, H, D = q.shape
    return (q.new_empty(B, T, H, D),
            q.new_empty(B, H, T, dtype=torch.float32))


@flash_causal_bwd.register_fake
def _(q, k, v, out, lse, dout):
    return tuple(q.new_empty(q.shape) for _ in range(3))


def _setup_context(ctx, inputs, output):
    q, k, v = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)


def _backward_formula(ctx, dout, _dlse):
    return flash_causal_bwd(*ctx.saved_tensors, dout)


flash_causal_fwd.register_autograd(_backward_formula,
                                   setup_context=_setup_context)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D) + causal mask).v over q, k, v [B, T, H, D].

    CPU tensors take the plain versions; CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise. Both go through the
    `flash_causal_fwd` / `flash_causal_bwd` ops.
    `flash_causal_attention.launches` counts forward launches and
    `.backward_launches` backward ones (three kernels each)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_causal_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return flash_causal_fwd(q, k, v)[0]


flash_causal_attention.launches = 0
flash_causal_attention.backward_launches = 0
