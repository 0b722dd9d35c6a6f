"""Single-query (decode) attention over a static KV cache.

Counterpart of `audiocraft_tpu/ops/flash_attention.py::decode_attention`, the
Pallas TPU kernel. On CUDA tensors `decode_attention` launches the hand-written
Hopper kernel `csrc/decode_attention.cu` (see its header for the design: it is
bound by the HBM bytes of the valid window); on CPU tensors it computes the
same function with `decode_attention_reference`. There is no other route.

The kernel splits the window across the blocks of a thread-block cluster:
`split_count` chooses the cluster size, `tile_shares` gives each block's
slots, and `decode_attention_split` is the plain version of that split (the
per-share partials of the online softmax and their combine, in the kernel's
order), which the CPU tests hold against the TPU kernel.

The number of valid slots `length` lives on the device, as the TPU kernel's
`length_ref`: an int32 tensor of one element on q's device (a host int is
turned into one). The kernel reads it and derives the window itself, so a
CUDA graph can replay one launch while the cache fills; the host sizes the
grid and the cluster from the cache's capacity S alone, and the shares past
the window's end are empty. On the CPU the plain versions read the length
with `.item()`.

Layouts: q [B, H, D]; k/v caches [B, S, H, D] (f32, bf16, or int8 with
per-(step, head) bf16 scales [B, S, H] or [B, S, H, 1]); `length` the number
of valid slots (the current step is the last valid one), 1 <= length <= S
(the kernel clamps to that range). Returns [B, H, D] in q's dtype.
"""
import ctypes
import functools
import math
import typing as tp

import torch

from . import _build

NEG_INF = -1e30
# online-softmax max floor of the TPU kernel (`_M_FLOOR`)
M_FLOOR = -1e4
LOG2E = 1.4426950408889634
# the kernels' split-S: slots per tile, the largest (portable) cluster, and
# the blocks per SM the cluster size aims for
TILE = 32
MAX_SPLIT = 8
BLOCKS_PER_SM = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_launch_fn = None

Length = tp.Union[int, torch.Tensor]


def length_tensor(length: Length, device) -> torch.Tensor:
    """`length` as the int32 tensor of one element on `device` that the
    kernel reads; a tensor already in that form is returned as it is."""
    if isinstance(length, torch.Tensor):
        return length
    return torch.tensor([length], dtype=torch.int32, device=device)


def _host_length(length: Length) -> int:
    """The length as a host int (reads a device tensor: CPU paths only)."""
    return int(length.item()) if isinstance(length, torch.Tensor) else length


def _window(length: int, past_context: tp.Optional[int]) -> tp.Tuple[int, int]:
    """Valid slots [lo, hi): s < length and, with a window,
    s >= length - 1 - past_context (`make_causal_bias` with q_pos = length-1)."""
    lo = 0 if past_context is None else max(0, length - 1 - past_context)
    return lo, length


def split_count(B: int, H: int, window: int, sm_count: int,
                tile: int = TILE) -> int:
    """Blocks per (row, head) of the decode kernels (their cluster size): the
    fewest that put BLOCKS_PER_SM blocks on every SM, at most MAX_SPLIT and
    at most one per `tile` slots of the window (so at least 1 and never more
    than the window's slots)."""
    want = -(-BLOCKS_PER_SM * sm_count // (B * H))
    return max(1, min(MAX_SPLIT, want, window // tile))


def tile_shares(lo: int, hi: int, n: int,
                tile: int = TILE) -> tp.List[tp.Tuple[int, int]]:
    """Slots [begin, end) of each of the n blocks over the window [lo, hi),
    as the kernels deal it (`decode_common.cuh::tile_share`): the window's
    tiles (`tile` slots at multiples of `tile`) in contiguous shares of
    ceil(tiles / n); trailing shares may be empty (begin == end)."""
    first, last = lo // tile, -(-hi // tile)
    per = -(-(last - first) // n)
    shares = []
    for rank in range(n):
        begin = first + rank * per
        end = min(last, begin + per)
        shares.append((max(begin * tile, lo), min(end * tile, hi))
                      if end > begin else (hi, hi))
    return shares


def tiles(begin: int, end: int,
          tile: int = TILE) -> tp.Iterator[tp.Tuple[int, int]]:
    """The slots [a, b) of each tile that meets [begin, end)."""
    if begin >= end:
        return
    for base in range(begin - begin % tile, end, tile):
        yield max(base, begin), min(base + tile, end)


def combine_shares(parts: tp.Sequence[tp.Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]) -> torch.Tensor:
    """The cluster's combine (`decode_common.cuh::cluster_combine_store`):
    base-2 partials (m [B, H], l [B, H], acc [B, H, D]) rescaled to their
    common max and summed in rank order; returns acc / l in f32."""
    m = parts[0][0].clamp_min(M_FLOOR * LOG2E)
    for part in parts[1:]:
        m = torch.maximum(m, part[0])
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pacc in parts:
        w = torch.exp2(pm - m)
        l = l + pl * w
        acc = acc + pacc * w[..., None]
    return acc / l[..., None]


def _check(q, k_cache, v_cache, length, past_context, k_scale, v_scale):
    """Shapes, dtypes and arguments. A length on the host or the CPU is
    checked against the capacity; one on the card is left to the kernel,
    which clamps it (reading it here would wait for the device)."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q [B, H, D] and k/v [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, S, H, D = k_cache.shape
    if tuple(q.shape) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)}")
    if isinstance(length, torch.Tensor):
        if (length.dtype != torch.int32 or length.numel() != 1
                or length.device != q.device):
            raise ValueError(f"a length tensor must be one int32 on "
                             f"{q.device}, got {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
    if not isinstance(length, torch.Tensor) or length.device.type == "cpu":
        if not 1 <= _host_length(length) <= S:
            raise ValueError(f"length {_host_length(length)} outside [1, {S}]")
    if past_context is not None and past_context < 0:
        raise ValueError(f"past_context must be >= 0, got {past_context}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if (k_scale is not None) != (k_cache.dtype == torch.int8):
        raise ValueError("scales are given exactly when the cache is int8, got "
                         f"{k_cache.dtype} with scales={k_scale is not None}")
    if k_cache.dtype != v_cache.dtype:
        raise ValueError(f"k/v dtypes differ: {k_cache.dtype}, {v_cache.dtype}")
    if k_scale is not None:
        for s in (k_scale, v_scale):
            if s.numel() != B * S * H or s.shape[:3] != (B, S, H):
                raise ValueError(f"scales must be [B, S, H(, 1)], got "
                                 f"{tuple(s.shape)}")


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, length: Length,
                               past_context: tp.Optional[int] = None,
                               k_scale: tp.Optional[torch.Tensor] = None,
                               v_scale: tp.Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same window, same f32 math, same
    max floor; reads only the valid slots."""
    _check(q, k_cache, v_cache, length, past_context, k_scale, v_scale)
    length = _host_length(length)
    B, S, H, D = k_cache.shape
    lo, hi = _window(length, past_context)
    k = k_cache[:, lo:hi].float()
    v = v_cache[:, lo:hi].float()
    if k_scale is not None:
        k = k * k_scale.reshape(B, S, H)[:, lo:hi, :, None].float()
        v = v * v_scale.reshape(B, S, H)[:, lo:hi, :, None].float()
    scale = 1.0 / (D ** 0.5)
    scores = torch.einsum("bhd,bshd->bhs", q.float() * scale, k)
    m = scores.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    e = torch.exp(scores - m)
    out = torch.einsum("bhs,bshd->bhd", e, v) / e.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: Length, n_split: int,
                           past_context: tp.Optional[int] = None,
                           k_scale: tp.Optional[torch.Tensor] = None,
                           v_scale: tp.Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: n_split shares of the window
    (`tile_shares`), each an online softmax over its tiles in base 2 (one max
    and one rescale per tile, the int8 scales applied to the score and to the
    weight), then `combine_shares`. The kernel's n_split comes from the
    capacity (`split_count(B, H, S, ...)`), so shares past the window's end
    may be empty."""
    _check(q, k_cache, v_cache, length, past_context, k_scale, v_scale)
    length = _host_length(length)
    B, S, H, D = k_cache.shape
    lo, hi = _window(length, past_context)
    qs = q.float() * (LOG2E / math.sqrt(D))
    if k_scale is not None:
        k_scale = k_scale.reshape(B, S, H).float()
        v_scale = v_scale.reshape(B, S, H).float()
    parts = []
    for begin, end in tile_shares(lo, hi, n_split):
        m = torch.full((B, H), M_FLOOR * LOG2E)
        l = torch.zeros(B, H)
        acc = torch.zeros(B, H, D)
        for a, b in tiles(begin, end):
            scores = torch.einsum("bhd,bshd->bhs", qs, k_cache[:, a:b].float())
            p_scale = 1.0
            if k_scale is not None:
                scores = scores * k_scale[:, a:b].transpose(1, 2)
                p_scale = v_scale[:, a:b].transpose(1, 2)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhs,bshd->bhd", p * p_scale, v_cache[:, a:b].float())
            m = m_new
        parts.append((m, l, acc))
    return combine_shares(parts).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: Length,
                     past_context: tp.Optional[int] = None,
                     k_scale: tp.Optional[torch.Tensor] = None,
                     v_scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q.K^T/sqrt(D) + validity mask).V for one query per (row, head).

    CPU tensors take `decode_attention_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation, so the launch can be
    captured into a CUDA graph), in clusters of `split_count(B, H, S)`
    blocks, or raise. Given a device length, the launch reads nothing of
    the device on the host."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, length,
                                          past_context, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_cache, v_cache, length, past_context, k_scale, v_scale)
    B, S, H, D = k_cache.shape
    tensors = [q, k_cache, v_cache] + ([k_scale, v_scale]
                                       if k_scale is not None else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attention needs contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype not in _DTYPE_CODES:
        raise ValueError(f"cache must be float32, bfloat16 or int8, got "
                         f"{k_cache.dtype}")
    if k_scale is not None and (k_scale.dtype != torch.bfloat16
                                or v_scale.dtype != torch.bfloat16):
        raise ValueError("int8 cache scales must be bfloat16")
    if D > 128 or D % 2:
        raise ValueError(f"head dim must be even and <= 128, got {D}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("k/v caches must be 16-byte aligned")
    length = length_tensor(length, q.device)
    n_split = split_count(B, H, S, _sm_count(q.device.index))
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), length.data_ptr(), B, S, H, D,
        -1 if past_context is None else past_context, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream, n_split)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
