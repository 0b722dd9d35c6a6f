"""Plain attention ops (counterpart of `audiocraft_tpu/ops/attention.py`).

Layouts: q [B, Tq, H, D]; k/v [B, Tk, Hkv, D] with H = Hkv * n_rep.
"""
import typing as tp

import torch

# the head dims that the flash causal-attention kernel takes
# (`ops/flash_causal_attention.py`); eligibility follows them
FLASH_CAUSAL_HEAD_DIMS = (64, 128)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA repeat-interleave on the heads axis."""
    if n_rep == 1:
        return x
    B, T, H, D = x.shape
    return x[:, :, :, None, :].expand(B, T, H, n_rep, D).reshape(
        B, T, H * n_rep, D)


def make_causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     past_context: tp.Optional[int] = None,
                     k_valid: tp.Optional[torch.Tensor] = None,
                     dtype=torch.float32) -> torch.Tensor:
    """Additive bias [Tq, Tk]: a key is allowed iff
    0 <= q_pos - k_pos (<= past_context) and its slot is valid."""
    delta = q_pos[:, None] - k_pos[None, :]
    valid = delta >= 0
    if past_context is not None:
        valid &= delta <= past_context
    if k_valid is not None:
        valid &= k_valid[None, :]
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=valid.device)
    return torch.where(valid, zero, neg)


def flash_causal_eligible(q_len: int, k_len: int, head_dim: int) -> bool:
    """True when `ops.flash_causal_attention` serves a full-sequence causal
    self-attention: square q/k (no cache offset) and a head dim the kernel
    takes (`FLASH_CAUSAL_HEAD_DIMS`; any other goes to the plain attention,
    on the card too). The JAX package also asked for the TPU backend, T >= 256 and an
    opt-in switch (default off), all from measurements on a TPU, where the
    Pallas kernel's backward recompute stacked on the layer remat's; none of
    that carries over to the H100, so an eligible CUDA call always launches
    the kernel."""
    return q_len == k_len and head_dim in FLASH_CAUSAL_HEAD_DIMS


def dropout(x: torch.Tensor, p: float,
            generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: zero with probability p, scale the rest by
    1 / (1 - p); the mask is drawn from `generator` (the default one if
    None). Identity at p = 0."""
    if p <= 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: tp.Optional[torch.Tensor] = None,
                          as_float32: bool = True, dropout_rate: float = 0.0,
                          generator: tp.Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Scaled dot-product attention with f32 logits and softmax.

    Inputs are cast to the compute dtype (f32 with `as_float32`, else q's);
    logits accumulate in f32; the weighted sum runs in the compute dtype.
    `bias` is [Tq, Tk] or broadcasts against [B, H, Tq, Tk]. With
    `dropout_rate > 0` the attention weights are dropped after the softmax
    (inverted dropout, mask drawn from `generator`)."""
    D = q.shape[-1]
    out_dtype = q.dtype
    scale = 1.0 / (D ** 0.5)
    compute = torch.float32 if as_float32 else q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", (q.to(compute) * scale).float(),
                          k.to(compute).float())
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    w = dropout(torch.softmax(logits, dim=-1), dropout_rate, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(compute), v.to(compute))
    return out.to(out_dtype)
