"""Carry the JAX package's parameters into the port's modules.

The inputs are the JAX parameter trees as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, params)`); this module imports neither JAX nor the
JAX package. Each function fills a module's `state_dict` and loads it
strictly, so a missing or extra parameter raises. Layout changes:
Dense `[in, out]` -> Linear `[out, in]`; fused `in_proj_weight` `[E, 3E]` ->
`[3E, E]`; stacked `emb` `[K, V, D]` / `linears` `[K, D, card]` -> K modules;
conv `[W, Cin, Cout]` -> `[Cout, Cin, W]` (transposed conv -> `[Cin, Cout, W]`)
with weight-norm `g`/`v`; LSTM `w_ih` `[C, 4H]` -> `weight_ih_l{n}` `[4H, C]`;
RVQ codebooks `[n_q, C, D]` -> one codebook per level; LayerScale `scale`
and the qk layer norms keep their names (`layer_scale_1.scale`,
`self_attn.q_layer_norm.weight`, ...). HTDemucs (`load_htdemucs`): conv2d
`[kh, kw, Cin, Cout]` -> `[Cout, Cin, kh, kw]`, transposed convs flipped
back along their kernel axis, DConv layers `layers_{j}_conv1/norm1/conv2/
norm2/scale` -> `layers.{j}.0/1/3/4/6`, flax `layers_{i}` -> `layers.{i}`.
MERT (`load_mert`): the JAX names -> Hugging Face `HubertModel`'s. The style
conditioner takes its `params`, and the two collections flax keeps outside
them: `batch_stats` (`bn_mean`, `bn_var` -> `batch_norm.running_mean`,
`running_var`) and `quantizer` (`style_rvq` -> `rvq.vq.layers.{q}`).
Multi-Band Diffusion (`load_diffusion_unet`, `load_band_processor`):
`enc_{d}`/`dec_{d}` -> `encoders.{d}`/`decoders.{depth-1-d}` (the deepest
decoder first), `GroupNorm_0` -> `norm`, `res_{j}` -> `res_blocks.{j}`,
`embedding_{d}` -> `embeddings.{d-1}`, the BiLSTM's `fwd_{i}`/`bwd_{i}` ->
`weight_*_l{i}` and `weight_*_l{i}_reverse`; the `MBPState` fields ->
the processor's buffers. AudioSeal (`load_audioseal`): the SEANet stacks
as for EnCodec, `msg_emb` -> `msg_processor.msg_embeddings`, the
detector's encoder, `reverse_convolution` and `head` ->
`detector.0.model`, `detector.0.reverse_convolution`, `detector.1`.
JASCO (`load_flow_matching`): `temb_dense_{i}` -> `temb.dense.{i}`,
`skip_proj_{i}` -> `transformer.skip_projections.{i}`, and its
conditioners (the chords' unused `output_proj` keeps the port's values).
The discriminators of codec training (`load_adversary`): 2-D kernels
`[kh, kw, Cin, Cout]` (`kernel_v` / `kernel_g` under weight norm) ->
`[Cout, Cin, kh, kw]` (`weight_v` / `weight_g`); MS-STFT's flax
`NormConv2d_{j}` -> `convs.{j}`, its last -> `conv_post`; MPD's
`disc_p{p}.conv_{i}` and MSD's `disc_{i}.conv_in` / `conv_{i}` /
`conv_mid` -> `discriminators.{k}.convs.{j}`, with `conv_post` kept.
A codec's codebooks carry their `inited` flag, so a codec that has not
trained yet (zero codebooks, not `inited`) loads as such. CLAP
(`load_clap`): the JAX tree of `modules.clap.load_clap_params` -> the
Hugging Face `ClapModel` names; a joint-embedding conditioner
(`load_joint_conditioner`, and inside `load_lm`): `output_proj` and the
`quantizer` collection's `joint_rvq` -> `quantizer.vq.layers.{q}`. DAC
(`load_dac`): `conv_in` / `block_{i}` / `conv_out` -> the dac package's
`encoder.block.*` and `decoder.model.*`, Snake's `alpha` [C] -> [1, C, 1].
"""
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from ..adversarial import (MultiPeriodDiscriminator, MultiScaleDiscriminator,
                           MultiScaleSTFTDiscriminator)
from ..models.encodec import InterleaveStereoCompressionModel
from ..modules.conditioners import (ChromaStemConditioner,
                                    JointEmbeddingConditioner, LUTConditioner,
                                    StyleConditioner, T5Conditioner)
from ..modules.conv import StreamableConv1d, StreamableConvTranspose1d
from ..modules.lstm import StreamableLSTM
from ..modules.seanet import SEANetResnetBlock

Tree = tp.Mapping[str, tp.Any]


def _load(module: nn.Module, state: tp.Dict[str, np.ndarray]) -> None:
    ref = module.state_dict()
    tensors = {k: torch.from_numpy(np.array(v)).to(
        device=ref[k].device, dtype=ref[k].dtype) if k in ref else v
        for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


def _dense(p: Tree, prefix: str, out: dict) -> None:
    out[prefix + "weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[prefix + "bias"] = p["bias"]


def _norm(p: Tree, prefix: str, out: dict) -> None:
    out[prefix + "weight"] = p["scale"]
    out[prefix + "bias"] = p["bias"]


def _mha(p: Tree, prefix: str, out: dict) -> None:
    out[prefix + "in_proj_weight"] = np.asarray(p["in_proj_weight"]).T
    if "in_proj_bias" in p:
        out[prefix + "in_proj_bias"] = p["in_proj_bias"]
    _dense(p["out_proj"], prefix + "out_proj.", out)
    for name in ("q_layer_norm", "k_layer_norm"):
        if name in p:
            _norm(p[name], prefix + name + ".", out)


def t5_state(params: Tree, num_layers: int, prefix: str = "") -> dict:
    """JAX `T5Encoder` params -> the port's (Hugging Face) T5 keys."""
    p = _params(params)
    out = {prefix + "shared.weight": p["shared"]["embedding"]}
    for i in range(num_layers):
        blk = p[f"block_{i}"]
        rp = f"{prefix}encoder.block.{i}.layer."
        out[rp + "0.layer_norm.weight"] = blk["ln_attn"]["weight"]
        for name in ("q", "k", "v", "o"):
            out[rp + f"0.SelfAttention.{name}.weight"] = np.asarray(
                blk["attn"][name]["kernel"]).T
        if "relative_attention_bias" in blk["attn"]:
            out[rp + "0.SelfAttention.relative_attention_bias.weight"] = \
                blk["attn"]["relative_attention_bias"]
        out[rp + "1.layer_norm.weight"] = blk["ln_ff"]["weight"]
        for name in ("wi", "wi_0", "wi_1", "wo"):
            if name in blk:
                out[rp + f"1.DenseReluDense.{name}.weight"] = np.asarray(
                    blk[name]["kernel"]).T
    out[prefix + "encoder.final_layer_norm.weight"] = p["final_ln"]["weight"]
    return out


def load_t5(t5: nn.Module, params: Tree) -> None:
    _load(t5, t5_state(params, len(t5.encoder.block)))


def transformer_state(p: Tree, num_layers: int, prefix: str = "") -> dict:
    """JAX `StreamingTransformer` params -> the port's layer keys."""
    out: dict = {}
    for i in range(num_layers):
        lp = p[f"layers_{i}"]
        rp = f"{prefix}layers.{i}."
        _mha(lp["self_attn"], rp + "self_attn.", out)
        for name in ("norm1", "norm2"):
            _norm(lp[name], rp + name + ".", out)
        for name in ("linear1", "linear2"):
            _dense(lp[name], rp + name + ".", out)
        if "cross_attn" in lp:
            _mha(lp["cross_attn"], rp + "cross_attention.", out)
            _norm(lp["norm_cross"], rp + "norm_cross.", out)
        for name in ("layer_scale_1", "layer_scale_2", "layer_scale_cross"):
            if name in lp:
                out[rp + name + ".scale"] = lp[name]["scale"]
    return out


def load_transformer(transformer: nn.Module, params: Tree) -> None:
    _load(transformer, transformer_state(_params(params),
                                         len(transformer.layers)))


def load_mha(mha: nn.Module, params: Tree) -> None:
    out: dict = {}
    _mha(_params(params), "", out)
    _load(mha, out)


def _codebooks(books, prefix: str, n_q: int, out: dict) -> None:
    """Stacked JAX RVQ codebooks [n_q, ...] -> one EMA codebook per level."""
    for q in range(n_q):
        rp = f"{prefix}{q}._codebook."
        out[rp + "embed"] = books.embed[q]
        out[rp + "embed_avg"] = books.embed_avg[q]
        out[rp + "cluster_size"] = books.cluster_size[q]
        out[rp + "inited"] = np.asarray(books.inited[q], np.float32).reshape(1)


def style_state(cond: StyleConditioner, params: Tree,
                batch_stats: tp.Optional[Tree] = None,
                quantizer: tp.Optional[Tree] = None,
                prefix: str = "") -> dict:
    """A JAX `StyleConditioner`'s params, batch statistics and RVQ state ->
    the port's keys (without `output_proj`, which `lm_state` adds)."""
    out: dict = {}
    if isinstance(cond.embed, nn.Linear):
        _dense(params["embed"], prefix + "embed.", out)
    else:
        for k in range(len(cond.embed)):
            out[f"{prefix}embed.{k}.weight"] = params["embed"][k]
    if cond.transformer is not None:
        out.update(transformer_state(params["transformer"],
                                     len(cond.transformer.layers),
                                     prefix + "transformer."))
    if cond.batch_norm is not None:
        out[prefix + "batch_norm.running_mean"] = batch_stats["bn_mean"]
        out[prefix + "batch_norm.running_var"] = batch_stats["bn_var"]
        out[prefix + "batch_norm.num_batches_tracked"] = np.zeros((), np.int64)
    if cond.rvq is not None:
        _codebooks(quantizer["style_rvq"].codebooks, prefix + "rvq.vq.layers.",
                   len(cond.rvq.vq.layers), out)
    return out


def load_style(cond: StyleConditioner, variables: Tree) -> None:
    """A JAX `StyleConditioner`'s variables ({'params', 'batch_stats',
    'quantizer'}) -> a port `StyleConditioner`."""
    out = style_state(cond, variables["params"],
                      variables.get("batch_stats"), variables.get("quantizer"))
    _dense(variables["params"]["output_proj"], "output_proj.", out)
    _load(cond, out)


def mert_state(params: Tree) -> dict:
    """JAX `MERTModel` params -> the port's (Hugging Face Hubert) keys."""
    p = _params(params)
    out: dict = {}
    fe = p["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        _conv_nd(fe[f"conv_{i}"], f"feature_extractor.conv_layers.{i}.conv.",
                 out)
        i += 1
    _norm(fe["group_norm"], "feature_extractor.conv_layers.0.layer_norm.", out)
    _norm(p["fp_layer_norm"], "feature_projection.layer_norm.", out)
    _dense(p["fp_projection"], "feature_projection.projection.", out)
    _conv_nd(p["pos_conv_embed"]["conv"], "encoder.pos_conv_embed.conv.", out)
    _norm(p["encoder_layer_norm"], "encoder.layer_norm.", out)
    i = 0
    while f"layers_{i}" in p:
        lp, rp = p[f"layers_{i}"], f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(lp[name], f"{rp}attention.{name}.", out)
        for name in ("intermediate_dense", "output_dense"):
            _dense(lp[name], f"{rp}feed_forward.{name}.", out)
        _norm(lp["layer_norm"], rp + "layer_norm.", out)
        _norm(lp["final_layer_norm"], rp + "final_layer_norm.", out)
        i += 1
    return out


def load_mert(model: nn.Module, params: Tree) -> None:
    """JAX `MERTModel` params -> a port `MERTModel`."""
    _load(model, mert_state(params))


def lm_state(lm: nn.Module, params: Tree) -> dict:
    """JAX `LMModel` variables -> {port parameter or buffer name: numpy
    array}. The map of `params` is linear (transposes and unstacking), so
    it carries a JAX gradient tree onto the port's parameter names as well;
    a style conditioner also reads the `batch_stats` and `quantizer`
    collections."""
    p = _params(params)
    collections = params if "params" in params else {}
    out: dict = {}
    for k in range(lm.n_q):
        out[f"emb.{k}.weight"] = p["emb"][k]
        out[f"linears.{k}.weight"] = np.asarray(p["linears"][k]).T
        if "linears_bias" in p:
            out[f"linears.{k}.bias"] = p["linears_bias"][k]
    if "out_norm" in p:
        _norm(p["out_norm"], "out_norm.", out)
    out.update(transformer_state(p["transformer"], lm.num_layers,
                                 "transformer."))
    for name, cond in lm.condition_provider.conditioners.items():
        cp = p[f"conditioners_{name}"]
        prefix = f"condition_provider.conditioners.{name}."
        _dense(cp["output_proj"], prefix + "output_proj.", out)
        if isinstance(cond, LUTConditioner):
            out[prefix + "embed.weight"] = cp["embed"]["embedding"]
        elif isinstance(cond, T5Conditioner):
            out.update(t5_state(cp["t5"], len(cond.t5.encoder.block),
                                prefix + "t5."))
        elif isinstance(cond, StyleConditioner):
            key = f"conditioners_{name}"
            out.update(style_state(
                cond, cp, collections.get("batch_stats", {}).get(key),
                collections.get("quantizer", {}).get(key), prefix))
        elif isinstance(cond, JointEmbeddingConditioner):
            if cond.quantizer is not None:
                books = collections["quantizer"][f"conditioners_{name}"]
                _codebooks(books["joint_rvq"].codebooks,
                           prefix + "quantizer.vq.layers.",
                           len(cond.quantizer.vq.layers), out)
        elif not isinstance(cond, ChromaStemConditioner):  # output_proj only
            raise TypeError(f"no weight rule for {type(cond).__name__}")
    return out


def load_lm(lm: nn.Module, params: Tree) -> None:
    """JAX `LMModel` params -> a port `LMModel`."""
    _load(lm, lm_state(lm, params))


def _conv(p: Tree, prefix: str, transposed: bool, out: dict) -> None:
    # [W, Cin, Cout] -> [Cout, Cin, W] (conv) or [Cin, Cout, W] (transposed)
    perm = (1, 2, 0) if transposed else (2, 1, 0)
    if "kernel_v" in p:
        out[prefix + "weight_v"] = np.asarray(p["kernel_v"]).transpose(perm)
        out[prefix + "weight_g"] = np.asarray(p["kernel_g"]).reshape(-1, 1, 1)
    else:
        out[prefix + "weight"] = np.asarray(p["kernel"]).transpose(perm)
    if "bias" in p:
        out[prefix + "bias"] = p["bias"]
    _group_norm(p, prefix, out)


def _group_norm(p: Tree, prefix: str, out: dict) -> None:
    # a time_group_norm's flax `GroupNorm_0` is the `norm` beside the conv:
    # `<...>.conv.conv.` -> `<...>.conv.norm.`
    if "GroupNorm_0" in p:
        parent = prefix[:-1].rpartition(".")[0]
        parent = f"{parent}.norm." if parent else "norm."
        for name, target in (("scale", "weight"), ("bias", "bias")):
            if name in p["GroupNorm_0"]:
                out[parent + target] = p["GroupNorm_0"][name]


def _seanet(p: Tree, model: nn.Sequential, prefix: str, decoder: bool,
            out: dict) -> None:
    """Walk the Sequential in order, naming each layer as the JAX package
    does (conv_in, res_{i}_{j}, down_{i}/up_{i}, lstm, conv_out)."""
    stage, j = -1 if decoder else 0, 0
    convs = [m for m in model if isinstance(m, StreamableConv1d)]
    for idx, m in enumerate(model):
        rp = f"{prefix}model.{idx}."
        if isinstance(m, StreamableConvTranspose1d):
            stage, j = stage + 1, 0
            _conv(p[f"up_{stage}"]["convtr"], rp + "convtr.convtr.", True, out)
        elif isinstance(m, SEANetResnetBlock):
            res = p[f"res_{stage}_{j}"]
            for our_i, ref_i in enumerate((1, 3)):
                _conv(res[f"block_{our_i}"]["conv"],
                      f"{rp}block.{ref_i}.conv.conv.", False, out)
            if "shortcut" in res:
                _conv(res["shortcut"]["conv"], rp + "shortcut.conv.conv.",
                      False, out)
            j += 1
        elif isinstance(m, StreamableLSTM):
            for n in range(m.lstm.num_layers):
                lp = p["lstm"][f"lstm_{n}"]
                out[f"{rp}lstm.weight_ih_l{n}"] = np.asarray(lp["w_ih"]).T
                out[f"{rp}lstm.weight_hh_l{n}"] = np.asarray(lp["w_hh"]).T
                out[f"{rp}lstm.bias_ih_l{n}"] = lp["b_ih"]
                out[f"{rp}lstm.bias_hh_l{n}"] = lp["b_hh"]
        elif isinstance(m, StreamableConv1d):
            if m is convs[0]:
                name = "conv_in"
            elif m is convs[-1]:
                name = "conv_out"
            else:  # encoder downsampling closes a stage
                name = f"down_{stage}"
                stage, j = stage + 1, 0
            _conv(p[name]["conv"], rp + "conv.conv.", False, out)


def load_seanet(model: nn.Module, params: Tree, decoder: bool) -> None:
    """JAX `SEANetEncoder`/`SEANetDecoder` params -> a port SEANet stack."""
    out: dict = {}
    _seanet(_params(params), model.model, "", decoder, out)
    _load(model, out)


def load_encodec(model: nn.Module, variables: Tree) -> None:
    """JAX EnCodec variables ({'params': {'encoder', 'decoder'},
    'quantizer': RVQ state}) -> a port `EncodecModel`, or the mono model
    inside an `InterleaveStereoCompressionModel`."""
    if isinstance(model, InterleaveStereoCompressionModel):
        model = model.model
    p = variables["params"]
    out: dict = {}
    _seanet(p["encoder"], model.encoder.model, "encoder.", False, out)
    _seanet(p["decoder"], model.decoder.model, "decoder.", True, out)
    _codebooks(variables["quantizer"].codebooks, "quantizer.vq.layers.",
               len(model.quantizer.vq.layers), out)
    _load(model, out)


def _conv2d(p: Tree, prefix: str, out: dict) -> None:
    # [kh, kw, Cin, Cout] -> [Cout, Cin, kh, kw]
    for name, target in (("kernel_v", "weight_v"), ("kernel", "weight")):
        if name in p:
            out[prefix + target] = np.asarray(p[name]).transpose(3, 2, 0, 1)
    if "kernel_g" in p:
        out[prefix + "weight_g"] = np.asarray(p["kernel_g"]).reshape(-1, 1, 1, 1)
    if "bias" in p:
        out[prefix + "bias"] = p["bias"]
    _group_norm(p, prefix, out)


def adversary_state(adversary: nn.Module, params: Tree) -> dict:
    """JAX MS-STFT, MPD or MSD discriminator params -> the port's keys."""
    p = _params(params)
    out: dict = {}
    for k, disc in enumerate(adversary.discriminators):
        rp = f"discriminators.{k}."
        if isinstance(adversary, MultiScaleSTFTDiscriminator):
            dp = p[f"disc_{k}"]
            for j in range(len(disc.convs)):
                _conv2d(dp[f"NormConv2d_{j}"], f"{rp}convs.{j}.conv.", out)
            _conv2d(dp[f"NormConv2d_{len(disc.convs)}"],
                    rp + "conv_post.conv.", out)
        elif isinstance(adversary, MultiPeriodDiscriminator):
            dp = p[f"disc_p{disc.period}"]
            for j in range(len(disc.convs)):
                _conv2d(dp[f"conv_{j}"], f"{rp}convs.{j}.conv.", out)
            _conv2d(dp["conv_post"], rp + "conv_post.conv.", out)
        elif isinstance(adversary, MultiScaleDiscriminator):
            dp = p[f"disc_{k}"]
            n = len(disc.convs)
            names = (["conv_in"] + [f"conv_{i}" for i in range(n - 2)]
                     + ["conv_mid"])
            for j, name in enumerate(names):
                _conv(dp[name], f"{rp}convs.{j}.conv.", False, out)
            _conv(dp["conv_post"], rp + "conv_post.conv.", False, out)
        else:
            raise TypeError(f"no map for {type(adversary).__name__}")
    return out


def load_adversary(adversary: nn.Module, params: Tree) -> None:
    _load(adversary, adversary_state(adversary, params))


def _conv_nd(p: Tree, prefix: str, out: dict) -> None:
    """flax Conv kernel [k..., Cin, Cout] -> torch [Cout, Cin, k...]."""
    kernel = np.asarray(p["kernel"])
    out[prefix + "weight"] = kernel.transpose(
        (kernel.ndim - 1, kernel.ndim - 2) + tuple(range(kernel.ndim - 2)))
    if "bias" in p:
        out[prefix + "bias"] = p["bias"]


def _conv_transpose_nd(p: Tree, prefix: str, out: dict) -> None:
    """flax ConvTranspose kernel [k..., Cin, Cout], which correlates ->
    torch [Cin, Cout, k...], which convolves: the first kernel axis flips."""
    kernel = np.asarray(p["kernel"])[::-1]
    out[prefix + "weight"] = kernel.transpose(
        (kernel.ndim - 2, kernel.ndim - 1) + tuple(range(kernel.ndim - 2)))
    if "bias" in p:
        out[prefix + "bias"] = p["bias"]


def htdemucs_state(params: Tree, depth: int, t_depth: int) -> dict:
    """JAX `HTDemucs` params -> the demucs package's state-dict keys."""
    p = _params(params)
    out: dict = {"freq_emb.embedding.weight":
                 p["freq_emb"]["embedding"]["embedding"]}
    for i in range(depth):
        for name in ("encoder", "tencoder"):
            lp, rp = p[f"{name}_{i}"], f"{name}.{i}."
            _conv_nd(lp["conv"], rp + "conv.", out)
            _conv_nd(lp["rewrite"], rp + "rewrite.", out)
            d = lp["dconv"]
            j = 0
            while f"layers_{j}_conv1" in d:
                dp = f"{rp}dconv.layers.{j}."
                _conv_nd(d[f"layers_{j}_conv1"], dp + "0.", out)
                _norm(d[f"layers_{j}_norm1"], dp + "1.", out)
                _conv_nd(d[f"layers_{j}_conv2"], dp + "3.", out)
                _norm(d[f"layers_{j}_norm2"], dp + "4.", out)
                out[dp + "6.scale"] = d[f"layers_{j}_scale"]["scale"]
                j += 1
        for name in ("decoder", "tdecoder"):
            lp, rp = p[f"{name}_{i}"], f"{name}.{i}."
            _conv_nd(lp["rewrite"], rp + "rewrite.", out)
            _conv_transpose_nd(lp["conv_tr"], rp + "conv_tr.", out)
    if "channel_upsampler" in p:
        for name in ("channel_upsampler", "channel_downsampler"):
            kernel = np.asarray(p[name]["kernel"])[0]   # [1, Cin, Cout]
            _conv_nd({"kernel": kernel, "bias": p[name]["bias"]},
                     name + ".", out)
            _conv_nd(p[name + "_t"], name + "_t.", out)
    ct = p["crosstransformer"]
    _norm(ct["norm_in"], "crosstransformer.norm_in.", out)
    _norm(ct["norm_in_t"], "crosstransformer.norm_in_t.", out)
    for i in range(t_depth):
        for ours, theirs in (("layers", "layers"), ("layers_t", "layers_t")):
            lp, rp = ct[f"{ours}_{i}"], f"crosstransformer.{theirs}.{i}."
            attn = "cross_attn." if i % 2 else "self_attn."
            _mha(lp["attn"], rp + attn, out)
            for name in ("linear1", "linear2"):
                _dense(lp[name], rp + name + ".", out)
            for name in ("norm1", "norm2", "norm3", "norm_out"):
                if name in lp:
                    _norm(lp[name], rp + name + ".", out)
            for name in ("gamma_1", "gamma_2"):
                out[rp + name + ".scale"] = lp[name]["scale"]
    return out


def load_htdemucs(model: nn.Module, params: Tree) -> None:
    """JAX `HTDemucs` params -> a port `HTDemucs`."""
    _load(model, htdemucs_state(params, model.depth,
                                len(model.crosstransformer.layers)))


def _groupnorm_resblocks(p: Tree, prefix: str, out: dict) -> None:
    j = 0
    while f"res_{j}" in p:
        rp, res = f"{prefix}res_blocks.{j}.", p[f"res_{j}"]
        for name in ("norm1", "norm2"):
            _norm(res[name], rp + name + ".", out)
        for name in ("conv1", "conv2"):
            _conv_nd(res[name], rp + name + ".", out)
        j += 1


def diffusion_unet_state(params: Tree, depth: int) -> dict:
    """JAX `DiffusionUnet` params -> upstream's (the port's) keys."""
    p = _params(params)
    out: dict = {"embedding.weight": p["embedding"]["embedding"]}
    for d in range(depth):
        if f"embedding_{d}" in p:
            out[f"embeddings.{d - 1}.weight"] = p[f"embedding_{d}"]["embedding"]
        enc, ep = p[f"enc_{d}"], f"encoders.{d}."
        _conv_nd(enc["conv"], ep + "conv.", out)
        _norm(enc["GroupNorm_0"], ep + "norm.", out)
        _groupnorm_resblocks(enc, ep, out)
        dec, dp = p[f"dec_{d}"], f"decoders.{depth - 1 - d}."
        _conv_transpose_nd(dec["convtr"], dp + "convtr.", out)
        _norm(dec["GroupNorm_0"], dp + "norm.", out)
        _groupnorm_resblocks(dec, dp, out)
    if "bilstm" in p:
        b = p["bilstm"]
        i = 0
        while f"fwd_{i}" in b:
            for ours, suffix in (("fwd", ""), ("bwd", "_reverse")):
                lp = b[f"{ours}_{i}"]
                for name in ("ih", "hh"):
                    out[f"bilstm.lstm.weight_{name}_l{i}{suffix}"] = \
                        np.asarray(lp[f"w_{name}"]).T
                    out[f"bilstm.lstm.bias_{name}_l{i}{suffix}"] = \
                        lp[f"b_{name}"]
            i += 1
        _dense(b["linear"], "bilstm.linear.", out)
    if "transformer" in p:
        out.update(transformer_state(p["transformer"], 6, "transformer."))
    if "conv_codec" in p:
        _conv_nd(p["conv_codec"], "conv_codec.", out)
    return out


def load_diffusion_unet(model: nn.Module, params: Tree) -> None:
    """JAX `DiffusionUnet` params -> a port `DiffusionUnet`."""
    _load(model, diffusion_unet_state(params, len(model.encoders)))


def load_band_processor(processor: nn.Module, state) -> None:
    """A JAX `MBPState` (counts, sum_x, sum_x2, sum_target_x2) -> a port
    `MultiBandProcessor`'s buffers."""
    _load(processor, {
        "counts": np.asarray(state.counts, np.float32).reshape(1),
        "sum_x": state.sum_x, "sum_x2": state.sum_x2,
        "sum_target_x2": state.sum_target_x2})


def load_audioseal(model, params: Tree) -> None:
    """JAX AudioSeal params ({'generator', 'detector'}, each with its
    'params') -> a port `AudioSeal`'s generator and detector."""
    gen, det = model.generator, model.detector
    p = _params(params["generator"])
    out: dict = {}
    _seanet(p["encoder"], gen.encoder.model, "encoder.", False, out)
    _seanet(p["decoder"], gen.decoder.model, "decoder.", True, out)
    if "msg_processor" in p:
        out["msg_processor.msg_embeddings.weight"] = \
            p["msg_processor"]["msg_emb"]["embedding"]
    _load(gen, out)
    p = _params(params["detector"])
    out = {}
    _seanet(p["encoder"], det.detector[0].model, "detector.0.", False, out)
    _conv_transpose_nd(p["reverse_convolution"],
                       "detector.0.reverse_convolution.", out)
    _conv_nd(p["head"], "detector.1.", out)
    _load(det, out)


def flow_matching_state(model: nn.Module, params: Tree) -> dict:
    """JAX `FlowMatchingModel` params -> the port's (upstream's) keys."""
    from ..modules.jasco_conditioners import ChordsEmbConditioner
    p = _params(params)
    out: dict = {"emb.weight": np.asarray(p["emb"]["kernel"]).T}
    _dense(p["linear"], "linear.", out)
    for i in range(2):
        _dense(p[f"temb_dense_{i}"], f"temb.dense.{i}.", out)
    _dense(p["temb_proj"], "temb_proj.", out)
    if "out_norm" in p:
        _norm(p["out_norm"], "out_norm.", out)
    tr = p["transformer"]
    out.update(transformer_state(tr, len(model.transformer.layers),
                                 "transformer."))
    i = 0
    while f"skip_proj_{i}" in tr:
        _dense(tr[f"skip_proj_{i}"], f"transformer.skip_projections.{i}.", out)
        i += 1
    own = model.state_dict()
    for name, cond in model.conditioners.items():
        cp = p[f"conditioners_{name}"]
        prefix = f"condition_provider.conditioners.{name}."
        if isinstance(cond, ChordsEmbConditioner):
            out[prefix + "emb.weight"] = cp["emb"]["embedding"]
            for key in ("weight", "bias"):   # unused, as upstream's
                out[prefix + "output_proj." + key] = \
                    own[prefix + "output_proj." + key].cpu().numpy()
            continue
        _dense(cp["output_proj"], prefix + "output_proj.", out)
        if isinstance(cond, LUTConditioner):
            out[prefix + "embed.weight"] = cp["embed"]["embedding"]
        elif isinstance(cond, T5Conditioner):
            out.update(t5_state(cp["t5"], len(cond.t5.encoder.block),
                                prefix + "t5."))
    return out


def load_flow_matching(model: nn.Module, params: Tree) -> None:
    """JAX `FlowMatchingModel` params -> a port `FlowMatchingModel`."""
    _load(model, flow_matching_state(model, params))


def load_joint_conditioner(cond: JointEmbeddingConditioner,
                           variables: Tree) -> None:
    """A JAX `JointEmbeddingConditioner`'s variables ({'params':
    {'output_proj'}, 'quantizer': {'joint_rvq': RVQ state}}) -> the port's
    (`output_proj`, `quantizer.vq.layers.{q}`)."""
    out: dict = {}
    _dense(_params(variables)["output_proj"], "output_proj.", out)
    if cond.quantizer is not None:
        _codebooks(variables["quantizer"]["joint_rvq"].codebooks,
                   "quantizer.vq.layers.", len(cond.quantizer.vq.layers), out)
    _load(cond, out)


def clap_state(params: Tree) -> dict:
    """The JAX CLAP params (`modules.clap.load_clap_params`) -> the port's
    (Hugging Face `ClapModel`) names: Dense kernels transposed, the patch
    embedding's HWIO kernel back to [C, 1, k, k], `stages.{i}.blocks.{j}`
    -> `layers.{i}.blocks.{j}` (`ln1` / `ln2` -> `layernorm_before` /
    `_after`, `proj` -> `attention.output.dense`, `fc1` / `fc2` ->
    `intermediate.dense` / `output.dense`), `text_layers.{i}` ->
    `encoder.layer.{i}`."""
    out: dict = {}
    ap = "audio_model.audio_encoder."
    bn = params["batch_norm"]
    out[ap + "batch_norm.weight"] = bn["scale"]
    out[ap + "batch_norm.bias"] = bn["bias"]
    out[ap + "batch_norm.running_mean"] = bn["mean"]
    out[ap + "batch_norm.running_var"] = bn["var"]
    out[ap + "batch_norm.num_batches_tracked"] = np.zeros((), np.int64)
    out[ap + "patch_embed.proj.weight"] = np.asarray(
        params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    out[ap + "patch_embed.proj.bias"] = params["patch_embed"]["bias"]
    _norm(params["patch_norm"], ap + "patch_embed.norm.", out)
    for i, stage in enumerate(params["stages"]):
        sp = f"{ap}layers.{i}."
        for j, blk in enumerate(stage["blocks"]):
            bp = f"{sp}blocks.{j}."
            _norm(blk["ln1"], bp + "layernorm_before.", out)
            for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
                _dense(blk[ours], f"{bp}attention.self.{theirs}.", out)
            out[bp + "attention.self.relative_position_bias_table"] = \
                blk["rel_bias_table"]
            _dense(blk["proj"], bp + "attention.output.dense.", out)
            _norm(blk["ln2"], bp + "layernorm_after.", out)
            _dense(blk["fc1"], bp + "intermediate.dense.", out)
            _dense(blk["fc2"], bp + "output.dense.", out)
        if stage.get("downsample") is not None:
            _norm(stage["downsample"]["norm"], sp + "downsample.norm.", out)
            out[sp + "downsample.reduction.weight"] = np.asarray(
                stage["downsample"]["reduction"]).T
    _norm(params["norm"], ap + "norm.", out)
    tp_ = "text_model."
    emb = params["embeddings"]
    out[tp_ + "embeddings.word_embeddings.weight"] = emb["word"]
    out[tp_ + "embeddings.position_embeddings.weight"] = emb["position"]
    out[tp_ + "embeddings.token_type_embeddings.weight"] = emb["token_type"]
    _norm(emb["norm"], tp_ + "embeddings.LayerNorm.", out)
    for i, layer in enumerate(params["text_layers"]):
        lp = f"{tp_}encoder.layer.{i}."
        for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
            _dense(layer[ours], f"{lp}attention.self.{theirs}.", out)
        _dense(layer["attn_out"], lp + "attention.output.dense.", out)
        _norm(layer["attn_norm"], lp + "attention.output.LayerNorm.", out)
        _dense(layer["fc1"], lp + "intermediate.dense.", out)
        _dense(layer["fc2"], lp + "output.dense.", out)
        _norm(layer["out_norm"], lp + "output.LayerNorm.", out)
    _dense(params["pooler"], tp_ + "pooler.dense.", out)
    for tower in ("text_projection", "audio_projection"):
        for k in ("linear1", "linear2"):
            _dense(params[tower][k], f"{tower}.{k}.", out)
    return out


def load_clap(model: nn.Module, params: Tree) -> None:
    """The JAX CLAP params -> a port `modules.clap.ClapModel`."""
    _load(model, clap_state(params))


def _snake_alpha(p: Tree, prefix: str, out: dict) -> None:
    out[prefix + "alpha"] = np.asarray(p["alpha"]).reshape(1, -1, 1)


def _dac_res_unit(p: Tree, prefix: str, out: dict) -> None:
    _snake_alpha(p["snake1"], prefix + "block.0.", out)
    _conv(p["conv1"], prefix + "block.1.", False, out)
    _snake_alpha(p["snake2"], prefix + "block.2.", out)
    _conv(p["conv2"], prefix + "block.3.", False, out)


def dac_state(params: Tree, n_enc_blocks: int, n_dec_blocks: int,
              n_codebooks: int) -> dict:
    """JAX `DACModel` params -> the dac package's names: `conv_in`,
    `block_{i}` (`res_{j}`, `snake`, `conv` / `convtr`), `snake`, `conv_out`
    -> `encoder.block.*` / `decoder.model.*` in order, `in_projs_{i}` /
    `out_projs_{i}` / `codebooks[i]` -> `quantizer.quantizers.{i}`."""
    p = _params(params)
    out: dict = {}
    enc, dec, q = p["encoder"], p["decoder"], p["quantizer"]
    _conv(enc["conv_in"], "encoder.block.0.", False, out)
    for i in range(n_enc_blocks):
        bp, blk = f"encoder.block.{i + 1}.", enc[f"block_{i}"]
        for j in range(3):
            _dac_res_unit(blk[f"res_{j}"], f"{bp}block.{j}.", out)
        _snake_alpha(blk["snake"], f"{bp}block.3.", out)
        _conv(blk["conv"], f"{bp}block.4.", False, out)
    _snake_alpha(enc["snake"], f"encoder.block.{n_enc_blocks + 1}.", out)
    _conv(enc["conv_out"], f"encoder.block.{n_enc_blocks + 2}.", False, out)
    _conv(dec["conv_in"], "decoder.model.0.", False, out)
    for i in range(n_dec_blocks):
        bp, blk = f"decoder.model.{i + 1}.", dec[f"block_{i}"]
        _snake_alpha(blk["snake"], f"{bp}block.0.", out)
        _conv(blk["convtr"], f"{bp}block.1.", True, out)
        for j in range(3):
            _dac_res_unit(blk[f"res_{j}"], f"{bp}block.{j + 2}.", out)
    _snake_alpha(dec["snake"], f"decoder.model.{n_dec_blocks + 1}.", out)
    _conv(dec["conv_out"], f"decoder.model.{n_dec_blocks + 2}.", False, out)
    for i in range(n_codebooks):
        qp = f"quantizer.quantizers.{i}."
        _conv(q[f"in_projs_{i}"], qp + "in_proj.", False, out)
        _conv(q[f"out_projs_{i}"], qp + "out_proj.", False, out)
        out[qp + "codebook.weight"] = np.asarray(q["codebooks"])[i]
    return out


def load_dac(model: nn.Module, params: Tree) -> None:
    """JAX `DACModel` params -> a port `DACModel`."""
    _load(model, dac_state(params, len(model.encoder_rates),
                           len(model.decoder_rates), model.n_codebooks))
