"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the kernels and of whole requests and steps,
worked out from shapes.

`k1_bytes_and_ops`, `flash_bytes_and_ops` and `train_step_flops` are
copies of `chip_smoke.py`'s `_kernel_bytes_and_ops`,
`_flash_bytes_and_ops` and the model-FLOP count of its `phase_train`.
"""
import typing as tp

# NVIDIA H100 SXM, data sheet, dense: bf16 tensor cores, float32 outside
# the tensor cores, HBM3
PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

KV_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def k1_bytes_and_ops(B: int, H: int, D: int, length: int, kind: str,
                     q_dtype_bytes: int) -> tp.Tuple[int, int]:
    """HBM bytes (each input read once, the output written once) and f32
    operations of one decode-attention call over `length` valid slots."""
    n = B * length * H
    bytes_ = 2 * n * D * KV_BYTES[kind] + 2 * B * H * D * q_dtype_bytes
    ops = 4 * n * D  # q.k and p.v multiply-adds
    if kind == "int8":
        bytes_ += 2 * n * 2       # bf16 scales
        ops += 2 * n              # one scale on each score and weight
    return bytes_, ops


def k1_bound_s(B, H, D, length, kind="bfloat16", q_dtype_bytes=2) -> float:
    """The least time of one K1 call: bytes at HBM rate or f32 operations
    at the CUDA cores' rate, whichever is longer."""
    b, ops = k1_bytes_and_ops(B, H, D, length, kind, q_dtype_bytes)
    return max(b / PEAKS["hbm_bytes_per_s"], ops / PEAKS["f32_flops"])


def flash_bytes_and_ops(B: int, T: int, H: int, D: int, backward: bool
                        ) -> tp.Tuple[float, float]:
    """HBM bytes (each input read once, each output written once) and
    tensor-core operations of one causal attention call, bf16."""
    n = B * T * H * D
    causal_pairs = T * (T + 1) // 2
    fwd_ops = 4 * B * H * D * causal_pairs
    if backward:  # q, k, v, out, dO, lse in; dq, dk, dv out
        return 8 * n * 2 + B * H * T * 4, 2.5 * fwd_ops
    return 4 * n * 2 + B * H * T * 4, fwd_ops  # q, k, v in; out, lse out


def k2_bound_s(B, T, H, D, backward: bool) -> float:
    b, ops = flash_bytes_and_ops(B, T, H, D, backward)
    return max(b / PEAKS["hbm_bytes_per_s"], ops / PEAKS["bf16_flops"])


def train_step_flops(n_trunk: int, batch: int, steps: int, layers: int,
                     dim: int) -> float:
    """Model FLOPs of one LM training step: 6 N per token over the LM
    without its conditioners, plus 12 L T^2 d per sample of attention;
    `steps` is the pattern steps the LM sees (frames + 1)."""
    return (6 * n_trunk * batch * steps
            + 12 * layers * steps * steps * dim * batch)


def t5_flops(t5: dict, length: int, out_dim: int) -> float:
    """One row of the T5 encoder over `length` tokens and the output
    projection to the LM's width (multiply-adds counted twice)."""
    d, inner = t5["d_model"], t5["num_heads"] * t5["d_kv"]
    per_token = t5["num_layers"] * (4 * d * inner + 2 * d * t5["d_ff"])
    attention = t5["num_layers"] * 2 * 2 * length * length * inner
    return 2 * per_token * length + attention + 2 * d * out_dim * length


def generate_flops(lm: dict, t5: dict, rows: int, forwards: int,
                   cond_len: int) -> float:
    """Model FLOPs of one `generate` over `rows` LM rows (CFG included):
    per row and forward at position p, 2 N over the weights a step reads
    (self-attention's qkv and output, cross-attention's query and output,
    the feed-forward, the heads) plus attention over p + 1 cached keys and
    the `cond_len` text keys; per row once, the text keys' and values'
    projection and T5."""
    d, L = lm["dim"], lm["num_layers"]
    dense = L * (4 + 2 + 2 * lm["hidden_scale"]) * d * d \
        + lm["n_q"] * lm["card"] * d
    self_keys = forwards * (forwards + 1) // 2  # lengths 1 .. forwards
    per_row = (2 * dense * forwards
               + 4 * L * d * (self_keys + forwards * cond_len)
               + 2 * L * 2 * d * d * cond_len
               + t5_flops(t5, cond_len, d))
    return rows * per_row
