"""Cross-attention of one decode step over a request's constant text keys
and values (K4).

The TPU kernels have no counterpart: the JAX package attends its
precomputed cross K/V with the plain attention, which XLA fuses. On CUDA
tensors `cross_attention_step` launches the hand-written Hopper kernel
`csrc/cross_attention_step.cu` (see its header for the design: it streams
K and V once, bound by their HBM bytes); on CPU tensors it computes the
same function with `cross_attention_step_reference`. There is no other
route.

Layouts: q [B, H, D]; k/v [B, H, Tc, D], contiguous and 16-byte aligned
(the layout that `StreamingTransformer.precompute_cross_kv` stores once
per request), all Tc keys attended, no mask. q, k and v all f32 or all
bf16; D a multiple of 8, at most 128. Returns [B, H, D] in q's dtype.
Logits, the softmax and the weighted sum are f32.

`cross_attention_step.launches` counts the kernel's launches (the CUDA
route only): a captured CUDA graph replays the kernel without calling the
wrapper, so `models/lm.py::_replay_decode_steps` adds the captured count
per replay.
"""
import ctypes

import torch

from . import _build
from .decode_attention import _sm_count

MAX_HEAD_DIM = 128
# warps of one block per (row, head) when B * H warps alone leave the card
# short of this many warps per SM
WARPS_PER_SM = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launch_fn = None


def eligible_head_dim(D: int) -> bool:
    """True for the head dims the kernel takes: multiples of 8 (a row of
    whole 16-byte chunks), at most 128."""
    return D % 8 == 0 and 0 < D <= MAX_HEAD_DIM


def warps_per_head(B: int, H: int, sm_count: int) -> int:
    """Warps that share one (row, head): 4 or 2 where B * H warps alone
    would not put `WARPS_PER_SM` on every SM, else 1."""
    for w in (4, 2):
        if B * H * w <= WARPS_PER_SM * sm_count:
            return w
    return 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B, H, D] and k/v [B, H, Tc, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Tc, D = k.shape
    if tuple(q.shape) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if Tc < 1:
        raise ValueError("k/v hold no key")
    if not eligible_head_dim(D):
        raise ValueError(f"head dim must be a multiple of 8 and <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must be all float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{t.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cross_attention_step needs contiguous tensors")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")


def cross_attention_step_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 logits, softmax and
    weighted sum over every key."""
    _check(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhd,bhtd->bht", q.float() * scale, k.float())
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", w, v.float()).to(q.dtype)


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("cross_attention_step").cross_attention_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def cross_attention_step(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """softmax(q.K^T/sqrt(D)).V for one query per (row, head) over all Tc
    keys of k/v [B, H, Tc, D].

    CPU tensors take `cross_attention_step_reference`; CUDA tensors launch
    the kernel on the current stream (no synchronisation, so the launch
    can be captured into a CUDA graph), `warps_per_head(B, H, SMs)` warps
    to a (row, head), or raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cross_attention_step runs on cpu or cuda, not "
                         f"{q.device}")
    if q.device.type == "cpu":
        return cross_attention_step_reference(q, k, v)
    _check(q, k, v)
    B, H, Tc, D = k.shape
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Tc, D,
        _DTYPE_CODES[q.dtype], warps_per_head(B, H, _sm_count(q.device.index)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_attention_step kernel launch failed: CUDA "
                           f"error {err}")
    cross_attention_step.launches += 1
    return out


cross_attention_step.launches = 0
