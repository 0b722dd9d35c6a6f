"""The LM options the port added against the JAX package on the same
weights, at the debug size (dim 16, 4 heads, 2 layers, 4 x 400 codes,
lookup-table cross-attention conditioning), f32 on the CPU: rotary positions
('rope', 'sin_rope', with and without xPos), LayerScale, qk layer norms
(self- and cross-attention), and GQA (`kv_repeat` 2); plus the rotation
itself and the builder's routing of these config keys.

Every LayerScale and qk-norm parameter is drawn at random (seeded numpy)
before both models load it, so a mislaid parameter shows.

The builder options the port once refused: `weight_init` uniform and
`depthwise_init` global (each matrix's largest draw within [0.9, 1] of the
JAX package's bound, in both packages), `fuser.cross_attention_pos_emb`
(logits), and SEANet activations other than ELU with their parameters
(the codec's codes and decode on the JAX codec carrying the port's
weights).

Tolerances: logits atol 1e-4 / rtol 1e-4 (f32, sums in another order);
rotations atol 1e-5 / rtol 1e-5; greedy tokens and codec codes equal;
codec decode atol 1e-5 / rtol 1e-4."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import rope as jrope
from audiocraft_tpu.modules.patterns import \
    DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.models.lm import GenParams, LMModel
from audiocraft_tpu_torch.modules import rope
from audiocraft_tpu_torch.modules.conditioners import (ConditionFuser,
                                                       ConditioningAttributes,
                                                       LUTConditioner)
from audiocraft_tpu_torch.modules.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["happy rock with loud drums", "jazz"]
OPTIONS = {
    "rope": dict(positional_embedding="rope"),
    "sin_rope": dict(positional_embedding="sin_rope"),
    "rope_xpos": dict(positional_embedding="rope", xpos=True),
    "layer_scale": dict(layer_scale=0.3),
    "qk_layer_norm": dict(qk_layer_norm=True, qk_layer_norm_cross=True),
    "kv_repeat_2": dict(kv_repeat=2),
}
COMMON = dict(n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
              cross_attention=True, causal=True)


def _fuse():
    return {"cross": ["description"], "prepend": [], "sum": [],
            "input_interpolate": []}


def _perturb(tree, rng):
    """Random values for every leaf under a LayerScale or a qk norm."""
    if isinstance(tree, dict):
        return {k: (jax.tree.map(lambda x: rng.uniform(
                    0.5, 1.5, np.shape(x)).astype(np.float32), v)
                    if "layer_scale" in k or "layer_norm" in k
                    else _perturb(v, rng)) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=list(OPTIONS))
def models(request):
    opts = OPTIONS[request.param]
    jmodel = jlm.LMModel(
        pattern_provider=JaxDelayed(n_q=4),
        conditioners={"description": jcond.LUTConditioner(
            n_bins=128, dim=16, output_dim=16, tokenizer="whitespace")},
        fuser=jcond.ConditionFuser(_fuse()), **COMMON, **opts)
    params = jax.tree.map(np.asarray,
                          jlm.init_lm_params(jmodel, jax.random.PRNGKey(0)))
    params = _perturb(params, np.random.RandomState(1))
    port = LMModel(DelayedPatternProvider(n_q=4),
                   {"description": LUTConditioner(128, 16, 16, device="cpu")},
                   ConditionFuser(_fuse()), device="cpu", **COMMON,
                   **opts).eval()
    jax_weights.load_lm(port, params)
    return request.param, jmodel, jax.tree.map(jnp.asarray, params), port


def _attrs(cls):
    return [cls(text={"description": t}) for t in TEXTS]


def test_logits_match_jax(models):
    _, jmodel, params, port = models
    seq = np.random.RandomState(2).randint(0, 401, (2, 4, 9))
    ct = jmodel.apply(params, jlm.tokenize_conditions(
        jmodel, _attrs(jcond.ConditioningAttributes)),
        method=jlm.LMModel.compute_conditions)
    expected, _ = jmodel.apply(params, jnp.asarray(seq), ct)
    with torch.no_grad():
        got = port(torch.from_numpy(seq), port.compute_conditions(
            port.condition_provider.tokenize(_attrs(ConditioningAttributes))))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-4,
                               rtol=1e-4)


def test_greedy_tokens_match_jax(models):
    """Prefill and decode through the caches: rotations at the device
    offset, GQA through the masked plain attention."""
    _, jmodel, params, port = models
    expected = jlm.generate(jmodel, params, jax.random.PRNGKey(0),
                            conditions=_attrs(jcond.ConditioningAttributes),
                            max_gen_len=10,
                            gen=jlm.GenParams(use_sampling=False))
    got = port.generate(conditions=_attrs(ConditioningAttributes),
                        max_gen_len=10, gen=GenParams(use_sampling=False),
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("xpos, invert, scale", [
    (False, False, 1.0), (True, False, 1.0), (True, True, 1.0),
    (False, False, 0.5), (True, True, 0.7)])
def test_rope_rotation_matches_jax(xpos, invert, scale):
    x = np.random.RandomState(3).randn(2, 5, 3, 8).astype(np.float32)
    positions = np.arange(5) + 11
    jcfg = jrope.RopeConfig(dim=8, xpos=xpos, scale=scale)
    expected = jrope.rope_rotate(jcfg, jnp.asarray(x), jnp.asarray(positions),
                                 invert_decay=invert)
    got = rope.rope_rotate(rope.RopeConfig(dim=8, xpos=xpos, scale=scale),
                           torch.from_numpy(x), torch.from_numpy(positions),
                           invert_decay=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("extra", [dict(qk_layer_norm=True),
                                   dict(kv_repeat=2)])
def test_builder_takes_the_options(extra):
    """`transformer_lm` keys reach the modules: a config with the options
    (qk layer norms take no GQA, as in the JAX package) builds, its
    parameters carry the options' shapes, and it generates."""
    cfg = {"transformer_lm": dict(
        n_q=4, card=32, dim=16, num_heads=4, num_layers=1, hidden_scale=2,
        layer_scale=0.1, positional_embedding="sin_rope", xpos=True, **extra),
        "codebooks_pattern": {"modeling": "delay",
                              "delay": {"delays": [0, 1, 2, 3]}}}
    lm = builders.get_lm_model(cfg, device="cpu")
    attn = lm.transformer.layers[0].self_attn
    kv_dim = 16 // extra.get("kv_repeat", 1)
    assert attn.in_proj_weight.shape == (16 + 2 * kv_dim, 16)
    assert lm.transformer.layers[0].layer_scale_1.scale.shape == (16,)
    assert hasattr(attn, "q_layer_norm") == ("qk_layer_norm" in extra)
    assert attn.rope.xpos
    codes = lm.generate(num_samples=2, max_gen_len=6,
                        gen=GenParams(use_sampling=False), device="cpu")
    assert codes.shape == (2, 4, 6) and ((codes >= 0) & (codes < 32)).all()


# ------------------------------------------- builder options once refused

@pytest.mark.parametrize("weight_init, depthwise_init", [
    ("uniform", "global"), ("uniform", "current"), ("gaussian", "global"),
    ("uniform", None)])
def test_weight_init_draws_from_the_jax_distribution(weight_init,
                                                     depthwise_init):
    """`weight_init` uniform and `depthwise_init` global: every matrix is
    drawn with the JAX package's std (1/sqrt(fan_in), divided in layer i by
    sqrt(2 i) for 'current', by sqrt(2 L) for 'global'); uniform within
    sqrt(3) std, gaussian truncated at 3 std. Both packages' largest draw
    of each matrix lies in [0.9, 1] of that bound (uniform) or of 3 std
    (gaussian): the draws differ (torch's and JAX's generators), the
    distribution does not."""
    cfg = {"transformer_lm": dict(
        n_q=2, card=64, dim=64, num_heads=4, num_layers=3, hidden_scale=4,
        weight_init=weight_init, depthwise_init=depthwise_init,
        zero_bias_init=False),
        "codebooks_pattern": {"modeling": "delay",
                              "delay": {"delays": [0, 1]}}}
    lm = builders.get_lm_model(cfg, device="cpu", seed=3)
    jmodel = jlm.LMModel(pattern_provider=JaxDelayed(n_q=2), conditioners={},
                         fuser=jcond.ConditionFuser(_fuse()), n_q=2, card=64,
                         dim=64, num_heads=4, num_layers=3, hidden_scale=4,
                         weight_init=weight_init,
                         depthwise_init=depthwise_init)
    jparams = jlm.init_lm_params(jmodel, jax.random.PRNGKey(3))
    reach = math.sqrt(3) if weight_init == "uniform" else 3.0

    def bound(fan_in, layer):
        depth = {"current": layer + 1, "global": 3}.get(depthwise_init)
        std = 1 / math.sqrt(fan_in) / (math.sqrt(2 * depth) if depth else 1)
        return reach * std

    port = {f"layer{i}.{n}": (p.abs().max().item(), bound(p.shape[1], i))
            for i, layer in enumerate(lm.transformer.layers)
            for n, p in layer.named_parameters()
            if p.dim() == 2 and "norm" not in n}
    port["emb"] = (lm.emb[0].weight.abs().max().item(), reach / 8)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_leaves = {}
    for path, leaf in flat:
        names = [str(getattr(k, "key", k)) for k in path]
        layer = [int(n.split("_")[1]) for n in names if n.startswith("layers_")]
        if layer and names[-1] in ("kernel", "in_proj_weight"):
            jax_leaves["/".join(names)] = (float(np.abs(leaf).max()),
                                           bound(leaf.shape[0], layer[0]))
        elif names[-1] == "emb":
            jax_leaves["emb"] = (float(np.abs(leaf).max()), reach / 8)
    assert len(port) == len(jax_leaves) == 13
    for name, (peak, limit) in {**port, **{"jax " + k: v for k, v in
                                          jax_leaves.items()}}.items():
        assert 0.9 * limit <= peak <= limit * (1 + 1e-6), (name, peak, limit)


def test_cross_attention_pos_emb_logits_match_jax():
    """`fuser.cross_attention_pos_emb` with its scale: a sinusoidal
    embedding of the cross source's positions added before the
    cross-attention, on the same weights as the JAX package."""
    fuse = _fuse()
    jmodel = jlm.LMModel(
        pattern_provider=JaxDelayed(n_q=4),
        conditioners={"description": jcond.LUTConditioner(
            n_bins=128, dim=16, output_dim=16, tokenizer="whitespace")},
        fuser=jcond.ConditionFuser(fuse, cross_attention_pos_emb=True,
                                   cross_attention_pos_emb_scale=0.7),
        **COMMON)
    params = jax.tree.map(np.asarray,
                          jlm.init_lm_params(jmodel, jax.random.PRNGKey(0)))
    cfg = {"transformer_lm": dict(COMMON), "fuser": {
        **fuse, "cross_attention_pos_emb": True,
        "cross_attention_pos_emb_scale": 0.7}}
    fuser = builders.get_condition_fuser(cfg)
    assert fuser.cross_attention_pos_emb and \
        fuser.cross_attention_pos_emb_scale == 0.7
    port = LMModel(DelayedPatternProvider(n_q=4),
                   {"description": LUTConditioner(128, 16, 16, device="cpu")},
                   fuser, device="cpu", **COMMON).eval()
    jax_weights.load_lm(port, params)
    seq = np.random.RandomState(2).randint(0, 401, (2, 4, 9))
    ct = jmodel.apply(params, jlm.tokenize_conditions(
        jmodel, _attrs(jcond.ConditioningAttributes)),
        method=jlm.LMModel.compute_conditions)
    expected, _ = jmodel.apply(params, jnp.asarray(seq), ct)
    with torch.no_grad():
        got = port(torch.from_numpy(seq), port.compute_conditions(
            port.condition_provider.tokenize(_attrs(ConditioningAttributes))))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-4,
                               rtol=1e-4)
    fuser.cross_attention_pos_emb = False
    with torch.no_grad():
        plain = port(torch.from_numpy(seq), port.compute_conditions(
            port.condition_provider.tokenize(_attrs(ConditioningAttributes))))
    assert not np.allclose(plain.numpy(), np.asarray(expected), atol=1e-3)


@pytest.mark.parametrize("activation, params", [
    ("relu", None), ("GELU", None), ("elu", {"alpha": 0.5}),
    ("silu", {"alpha": 1.0}), ("leaky_relu", None), ("tanh", None)])
def test_seanet_activations_match_jax(activation, params):
    """SEANet activations other than ELU, with `activation_params` (only
    elu reads them, in both packages) and `norm_params` (read by neither
    under weight norm): the codec's encode and decode on the JAX package's
    codec carrying the port's weights through its converter."""
    from audiocraft_tpu.models import builders as jbuilders
    from audiocraft_tpu.utils import torch_port
    seanet = {"dimension": 8, "n_filters": 4, "n_residual_layers": 1,
              "ratios": [4, 2], "lstm": 0, "norm": "weight_norm",
              "activation": activation,
              "norm_params": {"num_groups": 1}}
    if params is not None:
        seanet["activation_params"] = params
    cfg = {"compression_model": "encodec", "encodec": {
        "autoencoder": "seanet", "quantizer": "rvq", "sample_rate": 8000,
        "channels": 1, "seanet": seanet,
        "rvq": {"n_q": 2, "bins": 16, "kmeans_init": False}}}
    port = builders.get_compression_model(cfg, device="cpu")
    with torch.no_grad():  # codebooks that are not all zero
        for layer in port.quantizer.vq.layers:
            layer._codebook.embed.normal_(generator=torch.Generator()
                                          .manual_seed(0))
    jmodel = jbuilders.get_compression_model(cfg)
    variables = torch_port.convert_encodec_state(
        {k: v.numpy() for k, v in port.state_dict().items()}, ratios=[4, 2],
        n_residual_layers=1, lstm=0, n_q=2)
    x = np.random.RandomState(0).randn(2, 1, 160).astype(np.float32)
    jcodes, _ = jmodel.encode(variables, jnp.asarray(x))
    jout = jmodel.decode(variables, jcodes)
    with torch.no_grad():
        codes, _ = port.encode(torch.from_numpy(x), device="cpu")
        out = port.decode(codes, device="cpu")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-4)
