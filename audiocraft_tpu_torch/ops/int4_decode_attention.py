"""Single-query (decode) attention over an int4-packed KV cache.

Counterpart of `scripts/pallas_int4_decode.py` (`quant_pack_kv`,
`int4_decode_attention`, `reference_attention`), a Pallas TPU kernel that
lives in a measurement script. On CUDA tensors `int4_decode_attention`
launches the hand-written Hopper kernel `csrc/int4_decode_attention.cu`; on
CPU tensors it computes the same function with
`int4_decode_attention_reference`. There is no other route.

Layout (as the script's): with HD2 = H * D / 2,
  k4 [B, S, HD2] int8: one byte holds two signed nibbles, low nibble = head
     dim d2 of plane 0 (dims [0, D/2)), high nibble = dim d2 of plane 1
     (dims [D/2, D)); column order h * D/2 + d2;
  v4t [B, HD2, S] int8: the same packing for V, stored transposed;
  k_scale / v_scale [B, S, 2, H] bf16: symmetric max|x| / 7 per (step,
     plane, head).

The function is the TPU kernel's: q * (1/sqrt(D)) rounded to bf16; scores =
dot_lo * ks[plane 0] + dot_hi * ks[plane 1] in f32; valid slots s < length
and, with a window, s >= length - 1 - past_context; the softmax max floored
at -1e4; the weights e * vs per plane rounded to bf16 before the V product;
out = acc / l in q's dtype. The TPU kernel keeps a running max per block of
256 slots and the CUDA kernel one per tile of 128 slots (`TILE`), each block
of a cluster over its share of the window, so their bf16 weights follow a
running max; the plain version takes one max over the whole window, which
changes the bf16 rounding of a weight by at most one ulp.
`int4_decode_attention_split` is the plain version of the kernel's split
(`decode_attention.tile_shares`, per-tile running max, `combine_shares`).
"""
import ctypes
import math
import typing as tp

import torch

from . import _build
from .decode_attention import (LOG2E, _sm_count, combine_shares, split_count,
                               tile_shares, tiles)
from .quant import div_scalar

M_FLOOR = -1e4
TILE = 128  # slots per tile of the kernel (and per running max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launch_fn = None


def quant_pack_kv(k: torch.Tensor, v: torch.Tensor
                  ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """[B, S, H, D] K/V pair -> (k4 [B, S, HD2], v4t [B, HD2, S], k_scale
    [B, S, 2, H], v_scale [B, S, 2, H]).

    Scale, division and rounding run in bf16, as the script's do on its bf16
    inputs, so the bytes and scales are the script's bit for bit."""
    if k.dim() != 4 or k.shape != v.shape or k.shape[-1] % 2:
        raise ValueError(f"expected k/v [B, S, H, D] with D even, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = k.shape

    def quant(x):
        x = x.to(torch.bfloat16)
        planes = torch.stack([x[..., :D // 2], x[..., D // 2:]], dim=2)
        # per (step, plane, head) scales [B, S, 2, H]
        s = div_scalar(planes.abs().amax(dim=-1), 7.0).clamp_min(1e-8)
        q = torch.round(planes / s[..., None]).clamp(-8, 7).to(torch.int8)
        packed = (q[:, :, 1] << 4) | (q[:, :, 0] & 0xF)       # [B, S, H, D/2]
        return packed.reshape(B, S, H * D // 2), s

    k4, ks = quant(k)
    v4, vs = quant(v)
    return k4, v4.transpose(1, 2).contiguous(), ks, vs


def _window(length: int, past_context: tp.Optional[int]) -> tp.Tuple[int, int]:
    """Valid slots [lo, hi): s < length and, with a window,
    s >= length - 1 - past_context."""
    lo = 0 if past_context is None else max(0, length - 1 - past_context)
    return lo, length


def _check(q, k4, v4t, k_scale, v_scale, length, past_context):
    if q.dim() != 3 or k4.dim() != 3 or v4t.dim() != 3:
        raise ValueError(f"expected q [B, H, D], k4 [B, S, HD2], v4t "
                         f"[B, HD2, S], got {tuple(q.shape)}, "
                         f"{tuple(k4.shape)}, {tuple(v4t.shape)}")
    B, H, D = q.shape
    S = k4.shape[1]
    if D % 2:
        raise ValueError(f"head dim must be even, got {D}")
    if tuple(k4.shape) != (B, S, H * D // 2) or \
            tuple(v4t.shape) != (B, H * D // 2, S):
        raise ValueError(f"k4 {tuple(k4.shape)} / v4t {tuple(v4t.shape)} do "
                         f"not match q {tuple(q.shape)}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != (B, S, 2, H):
            raise ValueError(f"scales must be [B, S, 2, H] = {(B, S, 2, H)}, "
                             f"got {tuple(s.shape)}")
    if k4.dtype != torch.int8 or v4t.dtype != torch.int8:
        raise ValueError(f"packed caches must be int8, got {k4.dtype}, "
                         f"{v4t.dtype}")
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside [1, {S}]")
    if past_context is not None and past_context < 0:
        raise ValueError(f"past_context must be >= 0, got {past_context}")


def _nibbles(packed: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Signed low and high nibbles of int8 bytes, as f32."""
    b = packed.to(torch.int32)
    return ((b << 28) >> 28).float(), (b >> 4).float()


def int4_decode_attention_reference(q: torch.Tensor, k4: torch.Tensor,
                                    v4t: torch.Tensor, k_scale: torch.Tensor,
                                    v_scale: torch.Tensor, length: int,
                                    past_context: tp.Optional[int] = None
                                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel; reads only the valid slots."""
    _check(q, k4, v4t, k_scale, v_scale, length, past_context)
    B, H, D = q.shape
    D2 = D // 2
    lo, hi = _window(length, past_context)
    n = hi - lo
    qs = (q.float() * (1.0 / math.sqrt(D))).to(torch.bfloat16).float()
    k_lo, k_hi = _nibbles(k4[:, lo:hi].reshape(B, n, H, D2))
    ks = k_scale[:, lo:hi].float()                          # [B, n, 2, H]
    scores = (torch.einsum("bshd,bhd->bsh", k_lo, qs[..., :D2]) * ks[:, :, 0]
              + torch.einsum("bshd,bhd->bsh", k_hi, qs[..., D2:]) * ks[:, :, 1])
    m = scores.amax(dim=1, keepdim=True).clamp_min(M_FLOOR)
    e = torch.exp(scores - m)                               # [B, n, H]
    vs = v_scale[:, lo:hi].float()
    g_lo = (e * vs[:, :, 0]).to(torch.bfloat16).float()
    g_hi = (e * vs[:, :, 1]).to(torch.bfloat16).float()
    v_lo, v_hi = _nibbles(v4t[:, :, lo:hi].reshape(B, H, D2, n))
    out = torch.cat([torch.einsum("bhds,bsh->bhd", v_lo, g_lo),
                     torch.einsum("bhds,bsh->bhd", v_hi, g_hi)], dim=-1)
    return (out / e.sum(dim=1)[..., None]).to(q.dtype)


def int4_decode_attention_split(q: torch.Tensor, k4: torch.Tensor,
                                v4t: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, length: int,
                                n_split: int,
                                past_context: tp.Optional[int] = None
                                ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: n_split shares of the window
    (`tile_shares`), each an online softmax over its tiles in base 2 whose
    bf16 weights e * vs follow the running max, then `combine_shares`."""
    _check(q, k4, v4t, k_scale, v_scale, length, past_context)
    B, H, D = q.shape
    D2 = D // 2
    lo, hi = _window(length, past_context)
    qs = (q.float() * (1.0 / math.sqrt(D))).to(torch.bfloat16).float()
    parts = []
    for begin, end in tile_shares(lo, hi, n_split, TILE):
        m = torch.full((B, H), M_FLOOR * LOG2E)
        l = torch.zeros(B, H)
        acc = torch.zeros(B, H, D)
        for a, b in tiles(begin, end, TILE):
            n = b - a
            k_lo, k_hi = _nibbles(k4[:, a:b].reshape(B, n, H, D2))
            ks = k_scale[:, a:b].float()                    # [B, n, 2, H]
            scores = (torch.einsum("bshd,bhd->bhs", k_lo, qs[..., :D2])
                      * ks[:, :, 0].transpose(1, 2)
                      + torch.einsum("bshd,bhd->bhs", k_hi, qs[..., D2:])
                      * ks[:, :, 1].transpose(1, 2)) * LOG2E
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            e = torch.exp2(scores - m_new[..., None])       # [B, H, n]
            l = l * alpha + e.sum(dim=-1)
            vs = v_scale[:, a:b].float()
            g_lo = (e * vs[:, :, 0].transpose(1, 2)).to(torch.bfloat16).float()
            g_hi = (e * vs[:, :, 1].transpose(1, 2)).to(torch.bfloat16).float()
            v_lo, v_hi = _nibbles(v4t[:, :, a:b].reshape(B, H, D2, n))
            acc = acc * alpha[..., None] + torch.cat(
                [torch.einsum("bhds,bhs->bhd", v_lo, g_lo),
                 torch.einsum("bhds,bhs->bhd", v_hi, g_hi)], dim=-1)
            m = m_new
        parts.append((m, l, acc))
    return combine_shares(parts).to(q.dtype)


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("int4_decode_attention").int4_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def int4_decode_attention(q: torch.Tensor, k4: torch.Tensor,
                          v4t: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, length: int,
                          past_context: tp.Optional[int] = None
                          ) -> torch.Tensor:
    """softmax(q.K^T/sqrt(D) + validity mask).V over the int4 cache, one
    query per (row, head): q [B, H, D] -> [B, H, D] in q's dtype.

    CPU tensors take `int4_decode_attention_reference`; CUDA tensors launch
    the kernel on the current stream (no synchronisation), in clusters of
    `split_count` blocks, or raise."""
    if q.device.type == "cpu":
        return int4_decode_attention_reference(q, k4, v4t, k_scale, v_scale,
                                               length, past_context)
    if q.device.type != "cuda":
        raise ValueError(f"int4_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k4, v4t, k_scale, v_scale, length, past_context)
    B, H, D = q.shape
    S = k4.shape[1]
    for t in (q, k4, v4t, k_scale, v_scale):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("int4_decode_attention needs contiguous tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
        raise ValueError("int4 cache scales must be bfloat16")
    if D not in (32, 64, 128):
        raise ValueError(f"the kernel takes head dims 32, 64 and 128, got {D}")
    if k4.data_ptr() % 16 or v4t.data_ptr() % 16:
        raise ValueError("packed caches must be 16-byte aligned")
    lo, hi = _window(length, past_context)
    n_split = split_count(B, H, hi - lo, _sm_count(q.device.index), TILE)
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k4.data_ptr(), v4t.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), B, S, H, D, lo, hi,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        n_split)
    if err:
        raise RuntimeError(f"int4_decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    int4_decode_attention.launches += 1
    return out


int4_decode_attention.launches = 0
