"""Plain PyTorch reference of MusicGen: the T5 text encoder and its output
projection, the LM over the delay pattern with cross-attention and the CFG
combine, the EnCodec decoder (RVQ lookup and SEANet decoder), and three
AdamW training steps of the LM with global-norm clipping.

It follows the published model (upstream audiocraft's state-dict names and
equations), imports nothing of the program under test and reads only a
state dict of plain tensors. Every product runs in float32 with TF32 off,
over full sequences without a cache. `Precision` puts a rounding before
each product's inputs: `F32` leaves them as they are, `FP8` rounds them
(and, in training, the gradients that flow back into them) to float8 e4m3
with a per-tensor scale, which is the training cells' control: the same
model computed one precision step below the bfloat16 that the
configurations train in. `FP8_STREAM`, the serving cells' control, also
holds the LM's residual stream in float8 between layers, as the program
holds its stream in bfloat16.
"""
import math
import re
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's type."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad)


class Precision:
    """The rounding applied to each input of a product."""

    def __init__(self, fp8: bool, stream: bool = False):
        self.fp8, self.held = fp8, stream

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def stream(self, x: torch.Tensor) -> torch.Tensor:
        """The LM's residual stream as it is held between layers."""
        return _Fp8.apply(x) if self.held else x


F32 = Precision(False)
FP8 = Precision(True)
FP8_STREAM = Precision(True, stream=True)

StateDict = tp.Dict[str, torch.Tensor]


def strict_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(x, w, p: Precision, b=None):
    y = p(x) @ p(w).t()
    return y if b is None else y + b


def _bias(sd: StateDict, name: str):
    return sd.get(name)


# ------------------------------------------------------------------ tokens

PUNCTUATION = "?:!.,;"


def hash_tokens(texts: tp.Sequence[tp.Optional[str]], n_bins: int
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The whitespace hash tokenizer of the T5 conditioner when no
    sentencepiece vocabulary is present: lowercase, strip ?:!.,;, sha256
    of each word modulo `n_bins`; a missing text is one pad token (0) with
    length 0. Returns ids [B, L] int64 and mask [B, L] (L >= 1)."""
    import hashlib
    rows, lengths = [], []
    for text in texts:
        if not text:
            rows.append([0])
            lengths.append(0)
            continue
        words = re.sub(f"[{re.escape(PUNCTUATION)}]", "", text.lower()).split()
        lengths.append(len(words))
        rows.append([int(hashlib.sha256(w.encode("utf-8")).hexdigest(), 16)
                     % n_bins for w in words] or [0])
    width = max(1, max(lengths))
    ids = torch.zeros(len(rows), width, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r[:width])
    mask = torch.arange(width)[None] < torch.tensor(lengths)[:, None]
    return ids, mask


# --------------------------------------------------------------------- T5

def relative_position_bucket(rel: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """T5's bidirectional relative-position buckets."""
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    max_exact = num_buckets // 2
    large = max_exact + (np.log(np.maximum(n, 1) / max_exact)
                         / np.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, large)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def t5_encode(sd: StateDict, prefix: str, arch: dict, ids: torch.Tensor,
              mask: torch.Tensor, p: Precision) -> torch.Tensor:
    """T5 v1.0 encoder: [B, L] ids -> [B, L, d_model] (not masked)."""
    H, dkv, eps = arch["num_heads"], arch["d_kv"], arch["layer_norm_epsilon"]
    B, L = ids.shape
    x = sd[prefix + "shared.weight"][ids]
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    buckets = torch.from_numpy(relative_position_bucket(
        rel, arch["relative_attention_num_buckets"],
        arch["relative_attention_max_distance"])).to(ids.device)
    table = sd[prefix + "encoder.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight"]
    bias = table[buckets].permute(2, 0, 1)[None]
    keep = mask.bool()[:, None, None, :]
    for i in range(arch["num_layers"]):
        b = f"{prefix}encoder.block.{i}.layer."
        h = rms_norm(x, sd[b + "0.layer_norm.weight"], eps)
        q, k, v = (linear(h, sd[f"{b}0.SelfAttention.{n}.weight"], p
                          ).view(B, L, H, dkv) for n in "qkv")
        logits = torch.einsum("bqhd,bkhd->bhqk", p(q), p(k)) + bias
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p(w), p(v)).reshape(B, L, H * dkv)
        x = x + linear(out, sd[b + "0.SelfAttention.o.weight"], p)
        h = rms_norm(x, sd[b + "1.layer_norm.weight"], eps)
        x = x + linear(F.relu(linear(h, sd[b + "1.DenseReluDense.wi.weight"], p)),
                       sd[b + "1.DenseReluDense.wo.weight"], p)
    return rms_norm(x, sd[prefix + "encoder.final_layer_norm.weight"], eps)


COND = "condition_provider.conditioners.description."


def text_condition(sd: StateDict, arch: dict, ids, mask, p: Precision):
    """The cross-attention source of the description: T5, the output
    projection, padding zeroed. [B, L, dim]."""
    h = t5_encode(sd, COND + "t5.", arch["t5"], ids, mask, p)
    emb = linear(h, sd[COND + "output_proj.weight"], p,
                 sd[COND + "output_proj.bias"])
    return emb * mask[..., None].to(emb.dtype)


# --------------------------------------------------------------------- LM

def sin_embedding(T: int, dim: int, device, max_period: float = 10000.0):
    half = dim // 2
    pos = torch.arange(T, device=device, dtype=torch.float32).view(1, -1, 1)
    adim = torch.arange(half, device=device, dtype=torch.float32).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def attention(q, k, v, p: Precision, causal: bool):
    """q [B, Tq, H, D], k/v [B, Tk, H, D] -> [B, Tq, H * D]."""
    B, Tq, H, D = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", p(q), p(k)) / math.sqrt(D)
    if causal:
        Tk = k.shape[1]
        future = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(future, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p(w), p(v)).reshape(B, Tq, H * D)


def lm_forward(sd: StateDict, arch: dict, seq: torch.Tensor,
               cross: torch.Tensor, p: Precision) -> torch.Tensor:
    """Pre-norm MusicGen LM over a pattern sequence [B, K, S] (every
    position, no cache) with the cross-attention source [B, L, dim] ->
    logits [B, K, S, card]."""
    D, H = arch["dim"], arch["num_heads"]
    B, K, S = seq.shape
    x = sum(sd[f"emb.{k}.weight"][seq[:, k]] for k in range(K))
    x = p.stream(x + sin_embedding(S, D, seq.device))

    def ln(h, name):
        return F.layer_norm(h, (D,), sd[name + ".weight"], sd[name + ".bias"],
                            eps=1e-5)

    for i in range(arch["num_layers"]):
        n = f"transformer.layers.{i}."
        h = ln(x, n + "norm1")
        qkv = linear(h, sd[n + "self_attn.in_proj_weight"], p,
                     _bias(sd, n + "self_attn.in_proj_bias"))
        q, k, v = (t.view(B, S, H, D // H) for t in qkv.chunk(3, dim=-1))
        x = p.stream(x + linear(attention(q, k, v, p, causal=True),
                                sd[n + "self_attn.out_proj.weight"], p,
                                _bias(sd, n + "self_attn.out_proj.bias")))
        h = ln(x, n + "norm_cross")
        w = sd[n + "cross_attention.in_proj_weight"]
        bc = _bias(sd, n + "cross_attention.in_proj_bias")
        q = linear(h, w[:D], p, None if bc is None else bc[:D])
        kv = linear(cross, w[D:], p, None if bc is None else bc[D:])
        k, v = (t.reshape(B, -1, H, D // H) for t in kv.chunk(2, dim=-1))
        x = p.stream(x + linear(attention(q.view(B, S, H, D // H), k, v, p,
                                          causal=False),
                                sd[n + "cross_attention.out_proj.weight"], p,
                                _bias(sd, n + "cross_attention.out_proj.bias")))
        h = ln(x, n + "norm2")
        x = p.stream(x + linear(F.gelu(linear(h, sd[n + "linear1.weight"], p,
                                              _bias(sd, n + "linear1.bias"))),
                                sd[n + "linear2.weight"], p,
                                _bias(sd, n + "linear2.bias")))
    x = ln(x, "out_norm")
    return torch.stack([linear(x, sd[f"linears.{k}.weight"], p,
                               _bias(sd, f"linears.{k}.bias"))
                        for k in range(K)], dim=1)


def delay_sequence(codes: torch.Tensor, delays: tp.Sequence[int],
                   special: int, steps: int):
    """The delay pattern: step s of codebook k holds code s - 1 - delays[k]
    where that is a frame of codes [B, K, T], else the special token.
    Returns the sequence [B, K, steps] and its validity mask [K, steps]."""
    B, K, T = codes.shape
    seq = torch.full((B, K, steps), special, dtype=torch.long,
                     device=codes.device)
    valid = torch.zeros(K, steps, dtype=torch.bool, device=codes.device)
    for k, d in enumerate(delays):
        n = max(0, min(T, steps - 1 - d))
        seq[:, k, 1 + d:1 + d + n] = codes[:, k, :n]
        valid[k, 1 + d:1 + d + n] = True
    return seq, valid


# ------------------------------------------------------------ served gaps

def cfg_logits(sd, arch, codes_row, cross_pair, p: Precision) -> torch.Tensor:
    """CFG-combined logits [K, S - 1, card] that predict steps 1 .. S - 1 of
    the pattern sequence of one served row's codes [K, T]; `cross_pair` is
    the conditional and the null cross sources [2, L, dim]."""
    K, T = codes_row.shape
    steps = T + max(arch["delays"]) + 1
    seq, _ = delay_sequence(codes_row[None], arch["delays"], arch["card"], steps)
    logits = lm_forward(sd, arch, seq[:, :, :-1].expand(2, -1, -1), cross_pair, p)
    cond, null = logits[0], logits[1]
    return null + (cond - null) * arch["cfg_coef"]


def served_gaps(sd: StateDict, arch: dict, codes_row: torch.Tensor,
                cross_pair: torch.Tensor, control: tp.Optional[Precision] = None,
                control_cross: tp.Optional[torch.Tensor] = None, top_k: int = 1,
                generator: tp.Optional[torch.Generator] = None) -> float:
    """The widest gap by which a served token's CFG logit lies below the
    reference's `top_k`-th best (its best for a greedy row; a sampled
    token inside the reference's top k reads 0), over every position the
    pattern predicts. With `control`, the token is the one that the
    control (with its own cross sources `control_cross`) puts first at
    each position, or with `top_k` > 1 the one it samples from its own top
    k at temperature 1 (`generator`), for the same prompt and served
    tokens."""
    K, T = codes_row.shape
    steps = T + max(arch["delays"]) + 1
    seq, valid = delay_sequence(codes_row[None], arch["delays"], arch["card"],
                                steps)
    ref = cfg_logits(sd, arch, codes_row, cross_pair, F32)  # [K, S-1, card]
    if control is None:
        tokens = seq[0, :, 1:]
    else:
        logits = cfg_logits(sd, arch, codes_row, control_cross, control)
        if top_k == 1:
            tokens = logits.argmax(-1)
        else:
            values, index = logits.topk(top_k, dim=-1)
            pick = torch.multinomial(values.softmax(-1).flatten(0, 1), 1,
                                     generator=generator)
            tokens = index.flatten(0, 1).gather(-1, pick).view(index.shape[:2])
    mask = valid[:, 1:]
    kth = ref.topk(top_k, dim=-1).values[..., -1]
    chosen = ref.gather(-1, tokens.clamp(0, arch["card"] - 1)[..., None])[..., 0]
    return float((kth - chosen).clamp_min(0)[mask].max())


# ---------------------------------------------------------- EnCodec decode

def _extra_padding(length, kernel, stride, padding_total):
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    return ideal - length


def conv1d(x, w, b, p: Precision, stride=1, dilation=1):
    """Non-causal SEANet conv: reflect padding, half on each side (one more
    on the left), plus what fills the last window."""
    k = (w.shape[-1] - 1) * dilation + 1
    total = k - stride
    extra = _extra_padding(x.shape[-1], k, stride, total)
    right = total // 2
    x = F.pad(x, (total - right, right + extra), mode="reflect")
    return F.conv1d(p(x), p(w), b, stride=stride, dilation=dilation)


def conv_transpose1d(x, w, b, p: Precision, stride):
    y = F.conv_transpose1d(p(x), p(w), b, stride=stride)
    total = w.shape[-1] - stride
    right = total // 2
    return y[..., total - right:y.shape[-1] - right]


def lstm(x, sd, prefix, layers, p: Precision):
    """[B, C, T] through `layers` LSTM layers (gates i, f, g, o), plus the
    input (skip)."""
    h_seq = x.permute(2, 0, 1)  # [T, B, C]
    inp = h_seq
    for layer in range(layers):
        w_ih = sd[f"{prefix}weight_ih_l{layer}"]
        w_hh = sd[f"{prefix}weight_hh_l{layer}"]
        bias = sd[f"{prefix}bias_ih_l{layer}"] + sd[f"{prefix}bias_hh_l{layer}"]
        T, B, C = inp.shape
        gates_x = linear(inp, w_ih, p) + bias
        h = inp.new_zeros(B, w_hh.shape[1])
        c = inp.new_zeros(B, w_hh.shape[1])
        outs = []
        for t in range(T):
            i, f, g, o = (gates_x[t] + linear(h, w_hh, p)).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        inp = torch.stack(outs)
    return (inp + h_seq).permute(1, 2, 0)


def codec_decode(sd: StateDict, arch: dict, codes: torch.Tensor,
                 p: Precision) -> torch.Tensor:
    """codes [B, K, T] -> waveform [B, 1, T * hop]: the sum of the RVQ
    levels' codewords, then the SEANet decoder (conv, LSTM, per ratio ELU,
    transposed conv and residual blocks, ELU, conv)."""
    z = sum(sd[f"quantizer.vq.layers.{k}._codebook.embed"][codes[:, k]]
            for k in range(codes.shape[1]))
    x = z.transpose(1, 2)

    def conv(x, i, **kw):
        n = f"decoder.model.{i}.conv.conv."
        return conv1d(x, sd[n + "weight"], sd[n + "bias"], p, **kw)

    x = conv(x, 0)
    i = 1
    if arch["lstm"]:
        x = lstm(x, sd, "decoder.model.1.lstm.", arch["lstm"], p)
        i = 2
    for ratio in arch["ratios"]:
        n = f"decoder.model.{i + 1}.convtr.convtr."
        x = conv_transpose1d(F.elu(x), sd[n + "weight"], sd[n + "bias"], p,
                             stride=ratio)
        i += 2
        for j in range(arch["n_residual_layers"]):
            n = f"decoder.model.{i}.block."
            h = conv1d(F.elu(x), sd[n + "1.conv.conv.weight"],
                       sd[n + "1.conv.conv.bias"], p,
                       dilation=arch["dilation_base"] ** j)
            h = conv1d(F.elu(h), sd[n + "3.conv.conv.weight"],
                       sd[n + "3.conv.conv.bias"], p)
            x = x + h
            i += 1
    return conv(F.elu(x), i + 1)


# --------------------------------------------------------------- training

def trainable(name: str) -> bool:
    """The parameters the LM trainer updates: all but the frozen T5."""
    return not name.startswith(COND + "t5.")


def train_steps(sd: StateDict, arch: dict, codes: torch.Tensor, ids, mask,
                optim: dict, steps: int, p: Precision = F32,
                rows_per_pass: int = 2, rows: tp.Optional[slice] = None
                ) -> dict:
    """`steps` updates of the LM on codes [B, K, T] with the texts' ids and
    mask: the CE over the positions the delay pattern predicts (mean over
    codebooks of each codebook's mean), its gradients (the batch in passes
    of `rows_per_pass` rows, summed), global-norm clipping (scale
    max_norm / (norm + 1e-6) when below 1), and AdamW. With `rows`, the
    loss is the mean over those rows only (a fault to read). Returns the
    losses, the clipped gradient norm of each trainable leaf at the first
    step, and the norm of each leaf's change after the last step."""
    params = {n: t.clone().requires_grad_(True) for n, t in sd.items()
              if trainable(n)}
    frozen = {n: t for n, t in sd.items() if not trainable(n)}
    start = {n: t.detach().clone() for n, t in params.items()}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    b1, b2 = optim["betas"]
    B, K, T = codes.shape
    delays = arch["delays"]
    seq, _ = delay_sequence(codes, delays, arch["card"], T + 1)
    counted = range(B) if rows is None else range(B)[rows]
    losses, first_grads = [], {}
    with torch.no_grad():
        t5 = t5_encode(sd, COND + "t5.", arch["t5"], ids, mask, p)
    for step in range(1, steps + 1):
        grads = {n: torch.zeros_like(t) for n, t in params.items()}
        total = 0.0
        order = list(counted)
        for lo in range(0, len(order), rows_per_pass):
            idx = order[lo:lo + rows_per_pass]
            w = {**frozen, **params}
            emb = linear(t5[idx], w[COND + "output_proj.weight"], p,
                         w[COND + "output_proj.bias"])
            cross = emb * mask[idx][..., None].to(emb.dtype)
            logits = lm_forward(w, arch, seq[idx], cross, p)
            loss = 0.0
            for k, d in enumerate(delays):
                n_t = T - d
                ce = F.cross_entropy(
                    logits[:, k, d:d + n_t].reshape(-1, arch["card"]),
                    codes[idx, k, :n_t].reshape(-1), reduction="sum")
                loss = loss + ce / (len(order) * n_t)
            loss = loss / K
            g = torch.autograd.grad(loss, list(params.values()))
            for n, gi in zip(params, g):
                grads[n] += gi
            total += float(loss.detach())
        losses.append(total)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = (optim["max_norm"] / (norm + 1e-6)).clamp(max=1.0)
        with torch.no_grad():
            for n, t in params.items():
                g = grads[n] * clip
                if step == 1:
                    first_grads[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** step)).sqrt() + optim["eps"]
                t.mul_(1 - optim["lr"] * optim["weight_decay"])
                t.addcdiv_(m[n], denom, value=-optim["lr"] / (1 - b1 ** step))
    change = {n: float(torch.linalg.vector_norm(t.detach() - start[n]))
              for n, t in params.items()}
    return {"losses": losses, "grads": first_grads, "change": change}
