"""The port's MAGNeT serving path vs the JAX package on the same weights
(small sizes, f32, greedy decoding on the CPU): the restricted-context
attention bias, the least-probable span masking, and `debug` generation
with non-overlapping spans (max and prod scoring) and with stride-1 spans,
with CFG, without conditions, and with a prompt; then top-p sampling, the
export packages and `builders.get_magnet_small_lm`. The same path on the
card is tested in `test_torch_gpu.py`.

Tolerances: tokens equal; waveforms atol 1e-4 / rtol 1e-3 (f32 codec decode
of equal codes, as `test_torch_musicgen.py`); the attention bias and the
span masks equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.models import lm_magnet as jmagnet
from audiocraft_tpu.models.magnet import MAGNeT as JaxMAGNeT
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules.patterns import \
    ParallelPatternProvider as JaxParallel
from audiocraft_tpu_torch.models import MAGNeT, builders, lm_magnet
from audiocraft_tpu_torch.models.lm_magnet import (
    MagnetLMModel, least_probable_span_masking)
from audiocraft_tpu_torch.modules.conditioners import (ConditionFuser,
                                                       ConditioningAttributes)
from audiocraft_tpu_torch.modules.patterns import ParallelPatternProvider
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

TEXTS = ["electro dance with a fast beat", "calm piano"]
STEPS = (3, 2, 2, 2)
WAV_TOL = dict(atol=1e-4, rtol=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def magnets():
    """`MAGNeT.get_pretrained('debug')` of both packages, the JAX weights
    carried into the port's."""
    jm = JaxMAGNeT.get_pretrained("debug")
    pm = MAGNeT.get_pretrained("debug", device="cpu")
    jax_weights.load_encodec(pm.compression_model, _np(jm.compression_variables))
    jax_weights.load_lm(pm.lm, _np(jm.lm_params))
    return jm, pm


def test_restricted_context_attn_bias_matches_jax(magnets):
    jm, pm = magnets
    for T in (1, 7, 12, 40):
        want = jm.lm.restricted_context_attn_bias(T)
        got = pm.lm.restricted_context_attn_bias(T)
        assert got.dtype == torch.float32 and tuple(got.shape) == (T, T)
        np.testing.assert_array_equal(got.numpy(), want)
        assert pm.lm.stage_attn_bias(0, T) is None
        np.testing.assert_array_equal(pm.lm.stage_attn_bias(2, T).numpy(),
                                      jm.lm.stage_attn_bias(2, T))
    bias = pm.lm.restricted_context_attn_bias(12)
    assert bias[0, 5] == 0.0 and bias[0, 6] == torch.finfo(torch.float32).min


@pytest.mark.parametrize("seed", range(6))
def test_least_probable_span_masking_matches_jax(seed):
    """Seeded scores, rounded so that many tie, and the DONT_REMASK score
    on a prefix, over every target count."""
    rs = np.random.RandomState(seed)
    T = rs.randint(6, 40)
    scores = np.round(rs.rand(T) * 4).astype(np.float32)
    scores[:rs.randint(0, 4)] = lm_magnet.DONT_REMASK_ME_SCORE
    for span_len in (2, 3):
        for n in range(0, T + 1):
            got = least_probable_span_masking(scores, n, span_len)
            want = jmagnet.least_probable_span_masking(scores, n, span_len)
            np.testing.assert_array_equal(got, want)


def _generate(jm, pm, texts, duration=0.52, **kw):
    for model in (jm, pm):
        model.set_generation_params(duration=duration, use_sampling=False,
                                    decoding_steps=STEPS, **{
                                        k: v for k, v in kw.items()
                                        if k != "span_scoring"})
        if "span_scoring" in kw:
            model.generation_params["span_scoring"] = kw["span_scoring"]
    jw, jt = jm.generate(texts, return_tokens=True)
    pw, pt = pm.generate(texts, return_tokens=True)
    return np.asarray(jw), np.asarray(jt), pw.numpy(), pt.numpy()


@pytest.mark.parametrize("kw,frames", [
    ({}, 12), ({"span_scoring": "prod"}, 12),
    ({"span_arrangement": "stride1"}, 13)],
    ids=["nonoverlap-max", "nonoverlap-prod", "stride1"])
def test_debug_magnet_generation_matches_jax(magnets, kw, frames):
    """13 frames of 25 Hz: non-overlapping spans of 3 cut them to 12, as
    in the JAX package; stride-1 spans keep 13. CFG annealed 10 -> 1."""
    jw, jt, pw, pt = _generate(*magnets, TEXTS, **kw)
    assert pt.shape == (2, 4, frames) and pw.shape == (2, 1, frames * 1280)
    assert pt.max() < 400
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pw, jw, **WAV_TOL)


def test_debug_magnet_constant_cfg_matches_jax(magnets):
    """A constant CFG coefficient of 3, the temperature not annealed."""
    jm, pm = magnets
    jt = jmagnet.generate_magnet(
        jm.lm, jm.lm_params, jax.random.PRNGKey(0),
        conditions=[jcond.ConditioningAttributes(text={"description": t})
                    for t in TEXTS], max_gen_len=12, use_sampling=False,
        max_cfg_coef=3.0, min_cfg_coef=3.0, decoding_steps=STEPS,
        anneal_temp=False)
    pt = pm.lm.generate(
        conditions=[ConditioningAttributes(text={"description": t})
                    for t in TEXTS], max_gen_len=12, use_sampling=False,
        max_cfg_coef=3.0, min_cfg_coef=3.0, decoding_steps=STEPS,
        anneal_temp=False, device="cpu")
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arrangement", ["nonoverlap", "stride1"])
def test_debug_magnet_prompt_matches_jax(magnets, arrangement):
    """A prompt of 4 frames (not a whole number of spans) is kept verbatim
    and the rest generated alike."""
    jm, pm = magnets
    prompt = np.random.RandomState(5).randint(0, 400, (2, 4, 4))
    common = dict(max_gen_len=15, use_sampling=False, decoding_steps=STEPS,
                  span_arrangement=arrangement)
    jt = jmagnet.generate_magnet(
        jm.lm, jm.lm_params, jax.random.PRNGKey(0), prompt=jnp.asarray(prompt),
        conditions=[jcond.ConditioningAttributes(text={"description": t})
                    for t in TEXTS], **common)
    pt = pm.lm.generate(torch.from_numpy(prompt), [
        ConditioningAttributes(text={"description": t}) for t in TEXTS],
        device="cpu", **common)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pt[..., :4].numpy(), prompt)


@pytest.fixture(scope="module")
def unconditioned():
    """A debug-sized MAGNeT LM with no conditioner: no CFG rows at all."""
    jmodel = jmagnet.MagnetLMModel(
        pattern_provider=JaxParallel(n_q=4), conditioners={},
        fuser=jcond.ConditionFuser({}), n_q=4, card=400, dim=16, num_heads=4,
        num_layers=2, causal=False, subcodes_context=2, span_len=3)
    params = jlm.init_lm_params(jmodel, jax.random.PRNGKey(3))
    lm = MagnetLMModel(ParallelPatternProvider(n_q=4), {}, ConditionFuser({}),
                       n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                       causal=False, subcodes_context=2, span_len=3,
                       device="cpu").eval()
    jax_weights.load_lm(lm, _np(params))
    return jmodel, params, lm


@pytest.mark.parametrize("scoring,arrangement", [
    ("max", "nonoverlap"), ("prod", "nonoverlap"), ("max", "stride1")])
def test_magnet_without_cfg_matches_jax(unconditioned, scoring, arrangement):
    """No conditions: one forward per step, no null rows."""
    jmodel, params, lm = unconditioned
    common = dict(num_samples=2, max_gen_len=12, use_sampling=False,
                  decoding_steps=STEPS, span_scoring=scoring,
                  span_arrangement=arrangement)
    jt = jmagnet.generate_magnet(jmodel, params, jax.random.PRNGKey(0),
                                 **common)
    pt = lm.generate(device="cpu", **common)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_top_p_tokens_lie_in_the_nucleus(magnets):
    """Each token sampled at top-p 0.9 is one of the most probable tokens
    whose mass before it is at most 0.9, over 20 seeds; a sampled request
    leaves no mask token."""
    _, pm = magnets
    lm = pm.lm
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    ct = lm.prepare_cfg_conditions(attrs)
    seq = torch.from_numpy(np.random.RandomState(6).randint(0, 401, (2, 4, 12)))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        logits = lm(torch.cat([seq, seq]), ct)
        logits = (logits[2:] + (logits[:2] - logits[2:]) * 4.0)[:, 1]
        probs = torch.softmax(logits / 2.0, dim=-1)
        for _ in range(20):
            tokens, p_tok = lm._sample_stage(
                seq, ct, 1, None, torch.tensor([4.0]), torch.tensor([2.0]),
                True, 0, 0.9, g)
            before = (probs * (probs > p_tok[..., None])).sum(-1)
            assert bool((before <= 0.9 + 1e-6).all())
            torch.testing.assert_close(
                probs.gather(-1, tokens[..., None])[..., 0], p_tok)
    pm.set_generation_params(duration=0.48, decoding_steps=STEPS)
    pm.set_seed(1)
    _, codes = pm.generate(TEXTS, return_tokens=True)
    assert tuple(codes.shape) == (2, 4, 12)
    assert int(codes.min()) >= 0 and int(codes.max()) < lm.card


MAGNET_LM_CFG = {
    "lm_model": "transformer_lm_magnet",
    "transformer_lm": {"n_q": 4, "card": 400, "dim": 16, "num_heads": 4,
                       "num_layers": 2, "hidden_scale": 4, "norm_first": True,
                       "bias_proj": False, "bias_ff": False,
                       "bias_attn": False, "causal": False,
                       "subcodes_context": 5,
                       "compression_model_framerate": 25,
                       "segment_duration": 10},
    "codebooks_pattern": {"modeling": "parallel"},
    "masking": {"span_len": 3},
    "conditioners": {"description": {"model": "lut", "lut": {
        "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}}},
    "fuser": {"cross": ["description"], "prepend": [], "sum": [],
              "input_interpolate": []},
    "classifier_free_guidance": {"inference_coef": 3.0},
    "dataset": {"segment_duration": 10}}
CODEC_CFG = {"compression_model": "encodec", "sample_rate": 32000,
             "channels": 1,
             "seanet": {"dimension": 32, "n_filters": 4,
                        "n_residual_layers": 1, "ratios": [10, 8, 16],
                        "lstm": 0, "norm": "none"},
             "rvq": {"n_q": 4, "bins": 400}}


def test_magnet_packages_load_in_both_packages(tmp_path):
    """A seeded MAGNeT LM saved as an export package builds a
    `MagnetLMModel` from its config in both packages (the JAX package reads
    it through `load_lm_model`) and generates the same greedy tokens;
    `load_lm_model_magnet` applies MAGNeT's config fixups."""
    from audiocraft_tpu_torch.models import loaders
    lm = builders.get_lm_model(MAGNET_LM_CFG, device="cpu", seed=7)
    lm.reset_parameters(7)
    codec = builders.get_debug_compression_model(device="cpu", seed=8)
    torch.save({"best_state": lm.state_dict(), "xp.cfg": MAGNET_LM_CFG},
               tmp_path / "state_dict.bin")
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    pm = MAGNeT.get_pretrained(str(tmp_path), device="cpu")
    assert isinstance(pm.lm, MagnetLMModel) and pm.max_duration == 10
    assert (pm.lm.span_len, pm.lm.subcodes_context) == (3, 5)
    jm = JaxMAGNeT.get_pretrained(str(tmp_path))
    _, jt, _, pt = _generate(jm, pm, ["calm"], duration=0.48)
    np.testing.assert_array_equal(pt, jt)
    lm2, cfg = loaders.load_lm_model_magnet(str(tmp_path), 25, device="cpu")
    assert lm2.compression_model_framerate == 25 and cfg["masking"] == {
        "span_len": 3}
    for key, value in lm.state_dict().items():
        assert torch.equal(lm2.state_dict()[key], value), key


def test_magnet_builder_at_full_width():
    """MAGNeT-small's LM (`solver/magnet/magnet_32khz`), on the meta
    device: dim 1024, 16 heads, 24 layers, 4 x 2048 codes over the parallel
    pattern, non-causal, T5-base by cross-attention, spans of 3, context
    +-5 steps; 10 s at 50 Hz give 498 steps."""
    lm = builders.get_magnet_small_lm(device="meta")
    assert isinstance(lm, MagnetLMModel)
    assert (lm.dim, lm.num_heads, lm.num_layers, lm.n_q, lm.card) == \
        (1024, 16, 24, 4, 2048)
    assert isinstance(lm.pattern_provider, ParallelPatternProvider)
    assert lm.cross_attention and not lm.transformer.layers[0].self_attn.causal
    assert (lm.span_len, lm.subcodes_context,
            lm.compression_model_framerate) == (3, 5, 50)
    t5 = lm.condition_provider.conditioners["description"].t5
    assert len(t5.encoder.block) == 12
    assert lm.span_len * (10 * 50 // lm.span_len) == 498


@pytest.fixture(scope="module")
def causal_debug_lm():
    from audiocraft_tpu.models import builders as jbuilders
    jmodel, params = jbuilders.get_debug_lm_model()
    lm = builders.get_debug_lm_model(device="cpu")
    jax_weights.load_lm(lm, _np(params))
    return jmodel, params, lm


def test_lm_attn_bias_matches_jax(causal_debug_lm):
    """`attn_bias` reaches every self-attention of a causal LM too (added
    to the causal bias, off the flash route), as in the JAX package; fed
    one step at a time through the KV caches, each step's row of the bias
    gives the same logits (the plain attention, not the decode kernel)."""
    jmodel, params, lm = causal_debug_lm
    rs = np.random.RandomState(9)
    codes = rs.randint(0, 400, (2, 4, 7))
    bias = (rs.rand(7, 7) * -3.0).astype(np.float32)
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    jattrs = [jcond.ConditioningAttributes(text={"description": t})
              for t in TEXTS]
    jct = jlm.jit_compute_conditions(jmodel, params,
                                     jlm.tokenize_conditions(jmodel, jattrs))
    want, _ = jmodel.apply(params, jnp.asarray(codes), jct,
                           attn_bias=jnp.asarray(bias))
    with torch.no_grad():
        ct = lm.compute_conditions(lm.condition_provider.tokenize(attrs))
        got = lm(torch.from_numpy(codes), ct,
                 attn_bias=torch.from_numpy(bias))
        caches = lm.transformer.init_cache(2, 7, torch.float32, "cpu")
        lm.transformer.precompute_cross_kv(lm.fuser.cross_source(ct), caches)
        steps = [lm(torch.from_numpy(codes[..., t:t + 1]), ct, caches=caches,
                    attn_bias=torch.from_numpy(bias[t:t + 1]))
                 for t in range(7)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(steps, dim=2).numpy(), got.numpy(),
                               rtol=0, atol=1e-5)
    unbiased = lm(torch.from_numpy(codes), ct)
    assert not torch.allclose(unbiased, got, atol=1e-3)
