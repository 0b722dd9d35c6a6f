"""Multi-codebook transformer LM and its autoregressive generation
(counterpart of `audiocraft_tpu/models/lm.py`).

Module attributes follow upstream audiocraft's state-dict keys (`emb.{k}`,
`linears.{k}`, `out_norm`, `transformer.layers.{i}...`,
`condition_provider.conditioners.{name}...`).

`compute_predictions` is the training forward: codes -> the interleaved
pattern sequence -> logits reverted onto the codes' time axis, with the mask
of valid positions. `generate` is the port of the JAX package's compiled
decode program (`_get_decode_fn`: a prefill, then `lax.scan` over the
offsets): one step function reads the pattern step at a device offset, runs
every stream's forward, combines CFG, samples, writes the masked token and
advances the offset, all on the device. The KV caches are allocated once at
the full sequence length, written at their device index, and the
decode-attention kernel reads only their valid prefix. On the CPU the step
runs in a plain loop; on CUDA the prefill and the first single-token step
run eagerly (the warm-up), then one step is captured into a
`torch.cuda.CUDAGraph` and replayed for the remaining offsets. Classifier-free
guidance runs batched (the conditional and null rows in one batch), in
two steps (two streams, each with its own conditions, cache and forward),
or doubled for a melody model (`cfg_coef_beta`: conditional, waveform-only
and null rows in one batch). Prepended conditions (the melody's chroma, a
prepended text) enter at the prefill only: each stream's cache holds the
pattern steps plus its own prefix, and the positions and the
decode-attention length count from the cache's index, prefix included.
`quantize_lm_` puts the model in the W8A8 int8 serving mode; it runs through
the same graph.
"""
import dataclasses
import math
import time
import typing as tp

import torch
import torch.nn as nn

from ..modules.conditioners import (BaseConditioner,
                                    ClassifierFreeGuidanceDropout,
                                    ConditionFuser, ConditioningAttributes,
                                    ConditioningProvider, ConditionType,
                                    drop_description_condition)
from ..modules.patterns import CodebooksPatternProvider
from ..modules.transformer import LayerCache, StreamingTransformer
from ..ops.cross_attention_step import cross_attention_step
from ..ops.decode_attention import decode_attention
from ..ops.quant import QTensor, quantize_weight, w8a8_heads
from ..utils import tracing
from ..utils.utils import check_module_device, resolve_device, sample_tokens

ConditionTensors = tp.Dict[str, ConditionType]


@dataclasses.dataclass
class LMOutput:
    """Logits [B, K, T, card] aligned with the codes [B, K, T], and the mask
    [B, K, T] of the positions the pattern predicts. Positions outside the
    mask hold 0.0 (not NaN), so a loss selecting by the mask stays finite."""
    logits: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenParams:
    """Sampling and classifier-free-guidance settings."""
    use_sampling: bool = True
    temp: float = 1.0
    top_k: int = 250
    top_p: float = 0.0
    cfg_coef: tp.Optional[float] = None
    # double CFG (conditional, waveform-only and null rows); needs the
    # waveform condition of a melody model
    cfg_coef_beta: tp.Optional[float] = None
    # None: the model's `two_step_cfg`
    two_step_cfg: tp.Optional[bool] = None


def _combine_cfg_logits(all_logits: torch.Tensor, B: int, cfg_coef: float,
                        cfg_coef_beta: tp.Optional[float] = None
                        ) -> torch.Tensor:
    """Conditional rows first, null rows last; with `cfg_coef_beta`, the
    waveform-only rows between them (double CFG)."""
    if cfg_coef_beta is not None:
        cond_logits, wav_logits = all_logits[:B], all_logits[B:2 * B]
        uncond_logits = all_logits[2 * B:]
        return uncond_logits + cfg_coef * (
            wav_logits + cfg_coef_beta * (cond_logits - wav_logits)
            - uncond_logits)
    cond_logits, uncond_logits = all_logits[:B], all_logits[B:]
    return uncond_logits + (cond_logits - uncond_logits) * cfg_coef


class LMModel(nn.Module):
    """Transformer LM over `n_q` parallel code streams."""

    def __init__(self, pattern_provider: CodebooksPatternProvider,
                 conditioners: tp.Dict[str, BaseConditioner],
                 fuser: ConditionFuser, n_q: int = 8, card: int = 1024,
                 dim: int = 128, num_heads: int = 8, hidden_scale: int = 4,
                 norm_first: bool = False, bias_proj: bool = True,
                 cfg_coef: float = 1.0, two_step_cfg: bool = False,
                 num_layers: int = 8,
                 dropout: float = 0.0,
                 attention_dropout: tp.Optional[float] = None,
                 bias_ff: bool = True, bias_attn: bool = True,
                 causal: bool = True, past_context: tp.Optional[int] = None,
                 attention_as_float32: bool = False,
                 layer_scale: tp.Optional[float] = None,
                 positional_embedding: str = "sin", xpos: bool = False,
                 qk_layer_norm: bool = False, qk_layer_norm_cross: bool = False,
                 kv_repeat: int = 1,
                 cross_attention: bool = False, activation: str = "gelu",
                 checkpointing: str = "none", device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.pattern_provider = pattern_provider
        self.fuser = fuser
        self.n_q = n_q
        self.card = card
        self.dim = dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.cfg_coef = cfg_coef
        self.two_step_cfg = two_step_cfg
        self.cross_attention = cross_attention
        self.condition_provider = ConditioningProvider(conditioners)
        self.emb = nn.ModuleList([nn.Embedding(card + 1, dim, **factory)
                                  for _ in range(n_q)])
        self.transformer = StreamingTransformer(
            d_model=dim, num_heads=num_heads, num_layers=num_layers,
            dim_feedforward=int(hidden_scale * dim), dropout=dropout,
            attention_dropout=attention_dropout, bias_ff=bias_ff,
            bias_attn=bias_attn, causal=causal, past_context=past_context,
            attention_as_float32=attention_as_float32,
            cross_attention=cross_attention, layer_scale=layer_scale,
            positional_embedding=positional_embedding, xpos=xpos,
            qk_layer_norm=qk_layer_norm,
            qk_layer_norm_cross=qk_layer_norm_cross, kv_repeat=kv_repeat,
            norm_first=norm_first, activation=activation,
            checkpointing=checkpointing, **factory)
        self.out_norm = (nn.LayerNorm(dim, eps=1e-5, **factory)
                         if norm_first else None)
        self.linears = nn.ModuleList([nn.Linear(dim, card, bias=bias_proj,
                                                **factory)
                                      for _ in range(n_q)])
        # the heads' int8 weights [n_q, card, dim] in the W8A8 mode
        self.heads_q: tp.Optional[QTensor] = None

    @property
    def special_token_id(self) -> int:
        return self.card

    @torch.no_grad()
    def reset_parameters(self, seed: int, weight_init: str = "gaussian",
                         depthwise_init: tp.Optional[str] = "current",
                         zero_bias_init: bool = True) -> None:
        """Seeded random weights after upstream's LM init: every matrix
        (embeddings included) with std 1/sqrt(fan_in), drawn from a normal
        truncated at 3 std ('gaussian') or from U(-sqrt(3) std, sqrt(3) std)
        ('uniform'); inside layer i (1-based) the std is further divided by
        sqrt(2 i) ('current') or by sqrt(2 L), L the layer count ('global'),
        and not at all without `depthwise_init`. Biases are zeroed with
        `zero_bias_init` and keep their init otherwise; norms one/zero;
        layer scales keep their init. Conditioners keep their own init. On
        the meta device (shapes only) there is nothing to draw."""
        if weight_init not in ("gaussian", "uniform"):
            raise ValueError(f"unsupported weight_init {weight_init!r}")
        if depthwise_init not in (None, "current", "global"):
            raise ValueError(f"unsupported depthwise_init {depthwise_init!r}")
        if self.emb[0].weight.device.type == "meta":
            return
        g = torch.Generator(self.emb[0].weight.device).manual_seed(seed)

        def init_(t: torch.Tensor, std: float):
            if weight_init == "gaussian":
                t.normal_(0.0, std, generator=g).clamp_(-3 * std, 3 * std)
            else:
                bound = math.sqrt(3) * std
                t.uniform_(-bound, bound, generator=g)

        def bias_(t: tp.Optional[torch.Tensor]):
            if t is not None and zero_bias_init:
                t.zero_()

        for emb in self.emb:
            init_(emb.weight, 1 / math.sqrt(self.dim))
        for lin in self.linears:
            init_(lin.weight, 1 / math.sqrt(self.dim))
            bias_(lin.bias)
        n_layers = len(self.transformer.layers)
        for i, layer in enumerate(self.transformer.layers):
            depth = {"current": i + 1, "global": n_layers}.get(depthwise_init)
            depth_scale = math.sqrt(2 * depth) if depth else 1.0
            for name, p in layer.named_parameters():
                if "norm" in name:
                    p.fill_(1.0) if name.endswith("weight") else p.zero_()
                elif name.endswith("bias"):
                    bias_(p)
                elif name.startswith("layer_scale"):
                    continue
                else:  # [out, in] matrices
                    init_(p, 1 / math.sqrt(p.shape[1]) / depth_scale)
        if self.out_norm is not None:
            self.out_norm.reset_parameters()

    def embed_codes(self, sequence: torch.Tensor) -> torch.Tensor:
        """sum_k emb[k](sequence[:, k]): [B, K, S] -> [B, S, D]."""
        return sum(self.emb[k](sequence[:, k]) for k in range(self.n_q))

    def compute_conditions(self, tokenized: tp.Dict[str, tp.Any]
                           ) -> ConditionTensors:
        return self.condition_provider(tokenized)

    def forward(self, sequence: torch.Tensor,
                condition_tensors: ConditionTensors,
                caches: tp.Optional[tp.List[LayerCache]] = None,
                dropout_seed: tp.Optional[int] = None,
                first_step: bool = True,
                attn_bias: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card]. With `caches`, the
        steps are appended to them in place. Prepended conditions go before
        the sequence at the `first_step` only, and their logits are cut.
        `attn_bias` (f32, [S, S] or broadcasting against [B, H, S, S]) is
        added to every self-attention's logits."""
        B, K, S = sequence.shape
        assert K == self.n_q
        input_, cross_src = self.fuser(self.embed_codes(sequence),
                                       condition_tensors, first_step=first_step)
        out = self.transformer(input_, cross_attention_src=cross_src,
                               caches=caches, attn_bias=attn_bias,
                               dropout_seed=dropout_seed)
        if self.out_norm is not None:
            out = self.out_norm(out)
        if self.fuser.has_prepend and first_step:
            out = out[:, -S:]
        if self.heads_q is None:
            return torch.stack([lin(out) for lin in self.linears], dim=1)
        logits = w8a8_heads(out, self.heads_q)
        if self.linears[0].bias is None:
            return logits
        bias = torch.stack([lin.bias for lin in self.linears])
        return logits + bias.to(logits.dtype)[None, :, None, :]

    def compute_predictions(self, codes: torch.Tensor,
                            condition_tensors: ConditionTensors,
                            dropout_seed: tp.Optional[int] = None,
                            attn_bias: tp.Optional[torch.Tensor] = None
                            ) -> LMOutput:
        """Training forward: codes [B, K, T] -> logits [B, K, T, card] aligned
        with the codes, and their validity mask. The pattern sequence keeps
        only its valid steps (T + 1 for the delay pattern); `attn_bias`
        spans them (MAGNeT's stage bias)."""
        B, K, T = codes.shape
        pattern = self.pattern_provider.get_pattern(T)
        sequence, _, _ = pattern.build_pattern_sequence(
            codes, self.special_token_id, keep_only_valid_steps=True)
        logits = self(sequence, condition_tensors, dropout_seed=dropout_seed,
                      attn_bias=attn_bias)
        logits = logits.permute(0, 3, 1, 2)  # [B, card, K, S]
        logits, _, mask = pattern.revert_pattern_logits(
            logits, 0.0, keep_only_valid_steps=True)
        logits = logits.permute(0, 2, 3, 1)  # [B, K, T, card]
        mask = torch.from_numpy(mask).to(codes.device)[None].expand(B, K, T)
        return LMOutput(logits, mask)

    def prepare_cfg_conditions(self, conditions: tp.List[ConditioningAttributes],
                               two_step: bool = False,
                               cfg_coef_beta: tp.Optional[float] = None
                               ) -> tp.Union[ConditionTensors,
                                             tp.Tuple[ConditionTensors,
                                                      ConditionTensors]]:
        """Condition tensors for batched CFG: the conditional rows, then the
        null rows (every attribute dropped), tokenized together; with
        `cfg_coef_beta` (double CFG) the rows with the description dropped
        and the waveform kept go between them. With `two_step` (and no
        `cfg_coef_beta`), the conditional and the null rows are tokenized
        separately, each padded to its own length, and returned as a pair.
        Under cross-attention conditioning the two forms give the same
        logits: a null row is all padding, whose attention output does not
        depend on its length, and the conditional rows pad alike. Under
        prepended conditions they differ: a batched null row carries zeros
        of the conditional rows' prefix length, a two-step null stream its
        own shorter prefix."""
        if not conditions:
            return {}
        null_conditions = ClassifierFreeGuidanceDropout(p=1.0)(conditions)
        if cfg_coef_beta is not None:
            rows = (conditions + drop_description_condition(conditions)
                    + null_conditions)
        elif two_step:
            return tuple(self.compute_conditions(
                self.condition_provider.tokenize(c))
                for c in (conditions, null_conditions))
        else:
            rows = conditions + null_conditions
        return self.compute_conditions(self.condition_provider.tokenize(rows))

    @torch.no_grad()
    def generate(self, prompt: tp.Optional[torch.Tensor] = None,
                 conditions: tp.Sequence[ConditioningAttributes] = (),
                 condition_tensors: tp.Optional[ConditionTensors] = None,
                 num_samples: tp.Optional[int] = None, max_gen_len: int = 256,
                 gen: GenParams = GenParams(), cache_dtype=None,
                 generator: tp.Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        """Autoregressive generation; returns codes [B, K, max_gen_len] with
        the prompt retained. `condition_tensors`, when given, already holds
        the conditional and the null rows (2B of them; 3B with the
        waveform-only rows of double CFG), or for two-step CFG the pair
        (conditional, null) of B rows each. The model must be on `device`
        (CUDA unless the caller names another)."""
        device = resolve_device(device)
        check_module_device(self, device)
        conditions = list(conditions)
        if num_samples is None:
            num_samples = (prompt.shape[0] if prompt is not None
                           else len(conditions) if conditions else 1)
        cfg_coef = self.cfg_coef if gen.cfg_coef is None else gen.cfg_coef
        two_step = (self.two_step_cfg if gen.two_step_cfg is None
                    else gen.two_step_cfg)
        K = self.n_q
        if prompt is None:
            prompt = torch.zeros(num_samples, K, 0, dtype=torch.long)
        B, _, T = prompt.shape
        assert T < max_gen_len
        pattern = self.pattern_provider.get_pattern(max_gen_len)
        unknown, special = -1, self.special_token_id

        gen_codes = torch.full((B, K, max_gen_len), unknown, dtype=torch.long,
                               device=device)
        gen_codes[..., :T] = prompt.to(device)
        gen_sequence, _, _ = pattern.build_pattern_sequence(gen_codes, special)
        S = gen_sequence.shape[-1]
        start = pattern.get_first_step_with_timesteps(T)
        assert start is not None
        _, seq_mask_np = pattern._build_pattern_sequence_scatter_indexes(
            max_gen_len, K, keep_only_valid_steps=False)
        seq_mask = torch.from_numpy(seq_mask_np).to(device)  # [K, S]

        on_card = device.type == "cuda"
        with tracing.span("lm.conditions", device=on_card):
            if condition_tensors is None:
                condition_tensors = self.prepare_cfg_conditions(
                    conditions, bool(two_step), gen.cfg_coef_beta)
            cfg_mult = 1
            if condition_tensors:
                cfg_mult = 3 if gen.cfg_coef_beta is not None else 2
            # one stream of cfg_mult * B rows, or two streams of B
            # (two-step CFG)
            if isinstance(condition_tensors, tuple):
                streams, stream_batch = list(condition_tensors), B
            else:
                streams, stream_batch = [condition_tensors], cfg_mult * B
            cache_dtype = cache_dtype or self.emb[0].weight.dtype
            caches_list = []
            for ct in streams:
                # the pattern steps plus this stream's prepended conditions
                capacity = S + self.fuser.prepend_length(ct)
                caches = self.transformer.init_cache(stream_batch, capacity,
                                                     cache_dtype, device)
                if self.cross_attention and ct:
                    cross_src = self.fuser.cross_source(ct)
                    # cross K/V stay bf16 under an int8 self-attention cache
                    cross_dt = (torch.bfloat16 if cache_dtype == torch.int8
                                else cache_dtype)
                    self.transformer.precompute_cross_kv(
                        cross_src.to(cross_dt), caches)
                caches_list.append(caches)
        # the pattern step that the next step samples, on the device
        offset = torch.full((1,), start, dtype=torch.long, device=device)

        def step(tokens: tp.Optional[torch.Tensor] = None) -> None:
            """Forward `tokens` [B, K, t] (the prefill, behind the prepended
            conditions; default: the step before the offset), sample the
            step at the offset, write it where it is still unknown (the
            special token where the pattern has no code), and advance the
            offset. Only device ops: the step never waits for the device,
            so it can be captured."""
            first_step = tokens is not None
            if tokens is None:
                tokens = gen_sequence.index_select(2, offset - 1)
            if len(streams) == 1:
                seq_in = torch.cat([tokens] * cfg_mult) if cfg_mult > 1 else tokens
                logits = self(seq_in, streams[0], caches=caches_list[0],
                              first_step=first_step)
            else:
                logits = torch.cat([self(tokens, ct, caches=caches,
                                         first_step=first_step)
                                    for ct, caches in zip(streams, caches_list)])
            if cfg_mult > 1:
                logits = _combine_cfg_logits(logits, B, cfg_coef,
                                             gen.cfg_coef_beta)
            next_token = sample_tokens(
                logits[:, :, -1], use_sampling=gen.use_sampling, temp=gen.temp,
                top_k=gen.top_k, top_p=gen.top_p, generator=generator)[..., 0]
            valid = seq_mask.index_select(1, offset)[:, 0]  # [K]
            next_token = torch.where(valid, next_token, special)
            cur = gen_sequence.index_select(2, offset)[..., 0]
            gen_sequence.index_copy_(2, offset, torch.where(
                cur == unknown, next_token, cur)[..., None])
            offset.add_(1)

        with tracing.span("lm.prefill", device=on_card):
            step(gen_sequence[..., :start])
        decode_steps = S - 1 - start
        with tracing.span("lm.decode", steps=decode_steps):
            if on_card:
                _replay_decode_steps(step, decode_steps, device, generator)
            else:
                for _ in range(decode_steps):
                    step()

        gen_sequence = torch.where(seq_mask[None], gen_sequence,
                                   torch.full_like(gen_sequence, special))
        out_codes, _, _ = pattern.revert_pattern_sequence(
            gen_sequence, special_token=unknown)
        return out_codes[..., :max_gen_len]


@dataclasses.dataclass
class DecodeGraphStats:
    """What the decode graphs of this process did: the captures, the host
    seconds and device bytes (the graph's private memory pool, as
    `torch.cuda.memory_reserved` grew) of the last capture, and the CUDA
    events around the last generate's replays with their count. The same
    readings time the spans `lm.graph.capture` (host) and `lm.replays`
    (device) of `utils.tracing`."""
    captures: int = 0
    last_capture_s: float = 0.0
    last_capture_bytes: int = 0
    last_replays: tp.Optional[tp.Tuple[torch.cuda.Event, torch.cuda.Event,
                                       int]] = None

    def last_replay_ms_per_step(self) -> float:
        """Device milliseconds from the start of the last generate's first
        replay to the end of its last, per replay (waits for them)."""
        start, end, count = self.last_replays
        end.synchronize()
        return start.elapsed_time(end) / count


decode_graph_stats = DecodeGraphStats()
# the kernel wrappers whose launches a graph replay repeats uncounted
_COUNTED_KERNELS = (decode_attention, cross_attention_step)


def _replay_decode_steps(step: tp.Callable[[], None], steps: int,
                         device: torch.device,
                         generator: tp.Optional[torch.Generator]) -> None:
    """Run `steps` decode steps on the card: the first eagerly (the warm-up:
    kernel builds, cuBLAS workspaces, the kernels' shared-memory
    attributes), then the rest as replays of one CUDA graph of the step.
    Warm-up and capture share a side stream. The request's generator is
    registered with the graph, so each replay draws new numbers from it.
    A replay skips the kernel wrappers, so the K1 and K4 launches captured
    into the graph are counted once per replay instead of at capture.

    Spans (`utils.tracing`): `lm.warmup_step`, the eager step;
    `lm.graph.sync`, the host's wait for the prefill and the warm-up;
    `lm.graph.release`, the `empty_cache` before capture (cudaFree);
    `lm.graph.capture`, timed by the same clock readings as
    `decode_graph_stats.last_capture_s`; `lm.replays`, on the same CUDA
    events as `decode_graph_stats.last_replays`. None lies inside the
    captured step, where it would fire once, at capture."""
    if steps <= 0:
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with tracing.span("lm.warmup_step"), torch.cuda.stream(side):
        step()
    if steps == 1:
        torch.cuda.current_stream(device).wait_stream(side)
        return
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    launches = [f.launches for f in _COUNTED_KERNELS]
    with tracing.span("lm.graph.sync"):
        torch.cuda.synchronize(device)
    with tracing.span("lm.graph.release"):
        torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    with tracing.span("lm.graph.capture") as capture:
        t0 = time.time_ns()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            step()
        t1 = time.time_ns()
        capture.set_host(t0, t1)
    stats = decode_graph_stats
    stats.last_capture_s = (t1 - t0) / 1e9
    stats.last_capture_bytes = torch.cuda.memory_reserved(device) - reserved
    stats.captures += 1
    captured = [f.launches - n for f, n in zip(_COUNTED_KERNELS, launches)]
    for f, n in zip(_COUNTED_KERNELS, launches):
        f.launches = n  # nothing ran at capture
    stream = torch.cuda.current_stream(device)
    stream.wait_stream(side)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with tracing.span("lm.replays", steps=steps - 1) as replays:
        start.record(stream)
        for _ in range(steps - 1):
            graph.replay()
            for f, n in zip(_COUNTED_KERNELS, captured):
                f.launches += n
        end.record(stream)
        replays.set_events(start, end)
    stats.last_replays = (start, end, steps - 1)


@torch.no_grad()
def quantize_lm_(lm: LMModel) -> LMModel:
    """W8A8 int8 serving mode, in place (counterpart of the JAX package's
    `quantize_lm_params`): the fused qkv `in_proj_weight` of self- and
    cross-attention, every `out_proj`, `linear1` and `linear2`, and the
    per-codebook output heads become per-output-channel int8 `QTensor`s
    consumed by `ops.quant.qdot` / `w8a8_heads`. Embeddings, norms, biases
    and the conditioners keep their dtype. The quantized weights replace the
    parameters (they leave `parameters()` and `state_dict()`), so quantize a
    model after moving it to its device; it then serves inference only."""

    def swap(module: nn.Module, name: str) -> None:
        qt = quantize_weight(getattr(module, name))
        delattr(module, name)
        setattr(module, name, qt)

    for layer in lm.transformer.layers:
        for attn in (layer.self_attn, layer.cross_attention):
            if attn is not None:
                swap(attn, "in_proj_weight")
                swap(attn.out_proj, "weight")
        swap(layer.linear1, "weight")
        swap(layer.linear2, "weight")
    lm.heads_q = quantize_weight(torch.stack([lin.weight for lin in lm.linears]))
    for lin in lm.linears:
        del lin.weight
    return lm
