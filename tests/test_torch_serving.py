"""The port's serving variants vs the JAX package on the same weights (debug
sizes, f32, greedy decoding on the CPU): W8A8 int8 weights, two-step CFG,
continuation of an audio prompt (with the resampler and channel conversion
it uses), and interleaved stereo. The same paths on the card are tested in
`test_torch_gpu.py`.

Tolerances:
- int8 weights, scales, activations and int32 sums: bit-equal (the same
  rounding, half to even, in the same dtype);
- W8A8 logits: atol 1e-4 / rtol 1e-4 against the JAX package's W8A8 logits
  (equal int8 products; f32 norms, softmax and rescales summed in another
  order);
- greedy tokens: equal;
- resampling: atol 1e-5 (f32 windowed-sinc convolution, sums in another
  order);
- waveforms: atol 1e-4 / rtol 1e-3 (f32 codec decode of equal codes, as in
  `test_torch_musicgen.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.data.audio_utils import convert_audio as jax_convert_audio
from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.models.encodec import \
    InterleaveStereoCompressionModel as JaxStereo
from audiocraft_tpu.modules.conditioners import \
    ConditioningAttributes as JaxAttrs
from audiocraft_tpu.ops import quant as jquant
from audiocraft_tpu.ops.resample import resample_frac as jax_resample_frac
from audiocraft_tpu_torch.data.audio_utils import (convert_audio,
                                                   convert_audio_channels)
from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.models.encodec import InterleaveStereoCompressionModel
from audiocraft_tpu_torch.models.lm import GenParams, quantize_lm_
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.ops import quant
from audiocraft_tpu_torch.ops.resample import resample_frac
from audiocraft_tpu_torch.utils import jax_weights

# different word counts: cond and null rows pad to different lengths
TEXTS = ["happy rock with loud drums", "jazz"]
WAV_TOL = dict(atol=1e-4, rtol=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def debug_lm():
    jmodel, params = jbuilders.get_debug_lm_model()
    port = builders.get_debug_lm_model(device="cpu")
    jax_weights.load_lm(port, _np(params))
    return jmodel, params, port


@pytest.fixture(scope="module")
def debug_codec():
    jmodel, variables = jbuilders.get_debug_compression_model()
    port = builders.get_debug_compression_model(device="cpu")
    jax_weights.load_encodec(port, _np(variables))
    return jmodel, variables, port


def _attrs(cls, texts=TEXTS):
    return [cls(text={"description": t}) for t in texts]


# ------------------------------------------------------------------ W8A8

@pytest.mark.parametrize("shape", [(4, 7, 64, 96), (1, 2, 16, 48), (3, 1, 8, 8)])
def test_int8_values_scales_and_sums_equal_jax(shape):
    B, T, d_in, d_out = shape
    rs = np.random.RandomState(d_in)
    x = rs.randn(B, T, d_in).astype(np.float32)
    w = (rs.randn(d_in, d_out) * 0.1).astype(np.float32)  # JAX layout [in, out]
    w[:, 0] = 0.0  # an all-zero output channel takes the 1e-8 floor
    jqt = jquant.quantize_weight(jnp.asarray(w))
    qt = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(qt.w.numpy(), np.asarray(jqt.w).T)
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale)[0])
    jxq, jxs = jquant.quantize_acts(jnp.asarray(x))
    xq, xs = quant.quantize_acts(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    jacc = jax.lax.dot_general(jxq, jqt.w, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    acc = quant.int_mm(xq.reshape(-1, d_in), qt.w.t())
    np.testing.assert_array_equal(acc.numpy().reshape(B, T, d_out),
                                  np.asarray(jacc))
    np.testing.assert_array_equal(
        quant.w8a8_dot(torch.from_numpy(x), qt).numpy(),
        np.asarray(jquant.w8a8_dot(jnp.asarray(x), jqt, jnp.float32)))


def test_qtensor_row_slice_is_the_jax_column_slice():
    w = np.random.RandomState(2).randn(16, 24).astype(np.float32)
    x = np.random.RandomState(3).randn(3, 16).astype(np.float32)
    qt = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    sub = qt[:8]
    assert sub.w.shape == (8, 16) and sub.scale.shape == (8,)
    got = quant.qdot(torch.from_numpy(x), sub).numpy()
    want = jquant.qdot(jnp.asarray(x), jquant.quantize_weight(
        jnp.asarray(w))[:, :8], jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, quant.w8a8_dot(
        torch.from_numpy(x), qt).numpy()[:, :8])


def test_w8a8_heads_equal_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 32).astype(np.float32)
    w = (rs.randn(4, 32, 17) * 0.2).astype(np.float32)  # [K, D, C]
    want = jquant.w8a8_heads(jnp.asarray(x), jquant.quantize_weight(
        jnp.asarray(w)), jnp.float32)
    got = quant.w8a8_heads(torch.from_numpy(x), quant.quantize_weight(
        torch.from_numpy(w.transpose(0, 2, 1).copy())))
    assert got.shape == (2, 4, 5, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _quantized_pair(debug_lm):
    jmodel, params, _ = debug_lm
    port = builders.get_debug_lm_model(device="cpu")
    jax_weights.load_lm(port, _np(params))
    return jmodel, jlm.quantize_lm_params(jmodel, params), quantize_lm_(port)


def test_quantize_lm_takes_the_jax_set_of_weights(debug_lm):
    _, _, port = _quantized_pair(debug_lm)
    names = {n for n, _ in port.named_parameters()}
    for i in range(port.num_layers):
        layer = port.transformer.layers[i]
        for module, name in ((layer.self_attn, "in_proj_weight"),
                             (layer.cross_attention, "in_proj_weight"),
                             (layer.self_attn.out_proj, "weight"),
                             (layer.cross_attention.out_proj, "weight"),
                             (layer.linear1, "weight"),
                             (layer.linear2, "weight")):
            assert isinstance(getattr(module, name), quant.QTensor)
        assert f"transformer.layers.{i}.norm1.weight" in names
    assert port.heads_q.w.shape == (4, 400, 16)
    assert not any(n.startswith("linears.") and n.endswith("weight")
                   for n in names)
    # embeddings, biases and the conditioner keep their f32 weights
    assert {"emb.0.weight", "linears.0.bias",
            "condition_provider.conditioners.description.embed.weight",
            "condition_provider.conditioners.description.output_proj.weight"
            } <= names


def test_w8a8_logits_match_jax(debug_lm):
    jmodel, qparams, port = _quantized_pair(debug_lm)
    seq = np.random.RandomState(1).randint(0, 401, (2, 4, 9))
    ct = jmodel.apply(qparams, jlm.tokenize_conditions(jmodel, _attrs(JaxAttrs)),
                      method=jlm.LMModel.compute_conditions)
    want, _ = jmodel.apply(qparams, jnp.asarray(seq), ct)
    tct = port.compute_conditions(port.condition_provider.tokenize(
        _attrs(ConditioningAttributes)))
    with torch.no_grad():
        got = port(torch.from_numpy(seq), tct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_w8a8_greedy_tokens_match_jax(debug_lm):
    jmodel, qparams, port = _quantized_pair(debug_lm)
    want = jlm.generate(jmodel, qparams, jax.random.PRNGKey(0),
                        conditions=_attrs(JaxAttrs), max_gen_len=10,
                        gen=jlm.GenParams(use_sampling=False))
    got = port.generate(conditions=_attrs(ConditioningAttributes),
                        max_gen_len=10, gen=GenParams(use_sampling=False),
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ two-step CFG

def test_two_step_conditions_are_padded_separately(debug_lm):
    _, _, port = debug_lm
    attrs = _attrs(ConditioningAttributes)
    cond, null = port.prepare_cfg_conditions(attrs, two_step=True)
    batched = port.prepare_cfg_conditions(attrs)
    assert cond["description"][0].shape[:2] == (2, 5)
    assert null["description"][0].shape[:2] == (2, 1)
    assert batched["description"][0].shape[:2] == (4, 5)


def test_two_step_greedy_tokens_match_jax(debug_lm):
    jmodel, params, port = debug_lm
    want = jlm.generate(jmodel, params, jax.random.PRNGKey(0),
                        conditions=_attrs(JaxAttrs), max_gen_len=12,
                        gen=jlm.GenParams(use_sampling=False, two_step_cfg=True))
    got = port.generate(conditions=_attrs(ConditioningAttributes),
                        max_gen_len=12,
                        gen=GenParams(use_sampling=False, two_step_cfg=True),
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Batched CFG pads the null rows to 5 positions, two-step to 1. A null
    # row is all padding, so its positions are equal and cross-attention
    # returns the same value over 1 or 5 of them: the tokens agree too.
    batched = port.generate(conditions=_attrs(ConditioningAttributes),
                            max_gen_len=12, gen=GenParams(use_sampling=False),
                            device="cpu")
    assert torch.equal(got, batched)


def test_two_step_runs_one_forward_per_stream_and_step(debug_lm):
    _, _, port = debug_lm
    batches = []
    hook = port.transformer.layers[0].self_attn.register_forward_hook(
        lambda m, a, o: batches.append(a[0].shape[0]))
    try:
        port.generate(conditions=_attrs(ConditioningAttributes), max_gen_len=6,
                      gen=GenParams(use_sampling=False, two_step_cfg=True),
                      device="cpu")
    finally:
        hook.remove()
    S = len(port.pattern_provider.get_pattern(6).layout)
    assert batches == [2] * (2 * (S - 1))


def test_double_cfg_raises_naming_slice_c(debug_lm):
    """Double CFG is ported with slice C (`test_torch_melody.py`); on a
    model without a waveform condition it raises, as in the JAX package."""
    jmodel, params, port = debug_lm
    with pytest.raises(AssertionError, match="self_wav"):
        port.generate(conditions=_attrs(ConditioningAttributes), max_gen_len=4,
                      gen=GenParams(cfg_coef_beta=2.0), device="cpu")
    mg = MusicGen.get_pretrained("debug", device="cpu")
    mg.set_generation_params(duration=0.1, cfg_coef_beta=2.0)
    with pytest.raises(AssertionError, match="self_wav"):
        mg.generate(["a"])
    with pytest.raises(AssertionError):
        jlm.prepare_cfg_conditions(jmodel, params, _attrs(JaxAttrs),
                                   cfg_coef_beta=2.0)


# ------------------------------------------------- resampling and channels

@pytest.mark.parametrize("rates", [(44100, 32000), (32000, 16000),
                                   (16000, 24000), (48000, 32000)])
def test_resample_matches_jax(rates):
    x = np.random.RandomState(0).randn(2, 3, 1001).astype(np.float32)
    want = np.asarray(jax_resample_frac(jnp.asarray(x), *rates))
    got = resample_frac(torch.from_numpy(x), *rates).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", [(2, 1, 44100, 32000), (1, 2, 32000, 32000),
                                  (3, 2, 16000, 32000), (2, 2, 32000, 44100)])
def test_convert_audio_matches_jax(case):
    src_channels, channels, from_rate, to_rate = case
    x = np.random.RandomState(1).randn(2, src_channels, 700).astype(np.float32)
    want = np.asarray(jax_convert_audio(x, from_rate, to_rate, channels))
    got = convert_audio(x, from_rate, to_rate, channels).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_convert_audio_channels_rejects_upmixing_non_mono():
    with pytest.raises(ValueError):
        convert_audio_channels(torch.zeros(2, 3, 10), 4)


# ------------------------------------------------------------- continuation

def _debug_musicgen_pair(name="debug"):
    jmg = JaxMusicGen.get_pretrained(name)
    mg = MusicGen.get_pretrained(name, device="cpu")
    jax_weights.load_encodec(mg.compression_model,
                             _np(jmg.compression_variables))
    jax_weights.load_lm(mg.lm, _np(jmg.lm_params))
    for m in (jmg, mg):
        m.set_generation_params(use_sampling=False, duration=0.6)
    return jmg, mg


def test_continuation_matches_jax():
    """2 s of stereo at 44.1 kHz -> 32 kHz mono prompt -> continued greedily;
    the prompt's codes stay at the start."""
    jmg, mg = _debug_musicgen_pair()
    for m in (jmg, mg):
        m.max_duration = 1.0
        m.set_generation_params(use_sampling=False, duration=1.6,
                                extend_stride=0.5)
    prompt = (np.random.RandomState(2).randn(2, 2, 22050) * 0.1).astype(
        np.float32)  # 0.5 s
    jwav, jtok = jmg.generate_continuation(prompt, 44100, TEXTS,
                                           return_tokens=True)
    wav, tok = mg.generate_continuation(prompt, 44100, TEXTS,
                                        return_tokens=True)
    assert tok.shape == (2, 4, 40) and wav.shape == (2, 1, 40 * 1280)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), **WAV_TOL)
    prompt_tok, _ = mg.compression_model.encode(
        convert_audio(prompt, 44100, 32000, 1), device="cpu")
    assert torch.equal(tok[..., :prompt_tok.shape[-1]], prompt_tok)


@pytest.mark.parametrize("bad", ["ndim", "descriptions", "too_long"])
def test_continuation_checks_its_prompt(bad):
    mg = MusicGen.get_pretrained("debug", device="cpu")
    mg.set_generation_params(duration=0.4)
    prompt = np.zeros((1, 1, 6400), np.float32)
    descriptions = None
    error = AssertionError
    if bad == "ndim":
        prompt, error = prompt[None], ValueError
    elif bad == "descriptions":
        descriptions = ["a", "b"]
    elif bad == "too_long":
        prompt = np.zeros((1, 1, 32000), np.float32)
    with pytest.raises(error):
        mg.generate_continuation(prompt, 32000, descriptions)


# ------------------------------------------------------------------ stereo

@pytest.mark.parametrize("per_timestep", [False, True])
def test_stereo_layouts_match_jax(debug_codec, per_timestep):
    jmodel, variables, codec = debug_codec
    jst = JaxStereo(model=jmodel, per_timestep=per_timestep)
    st = InterleaveStereoCompressionModel(codec, per_timestep=per_timestep)
    x = (np.random.RandomState(3).randn(2, 2, 6400) * 0.1).astype(np.float32)
    jcodes, _ = jst.encode(variables, jnp.asarray(x))
    codes, scale = st.encode(torch.from_numpy(x), device="cpu")
    assert scale is None
    assert codes.shape == ((2, 4, 10) if per_timestep else (2, 8, 5))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    left, right = st.get_left_right_codes(codes)
    assert torch.equal(left, codec.encode(torch.from_numpy(x[:, :1]),
                                          device="cpu")[0])
    assert torch.equal(right, codec.encode(torch.from_numpy(x[:, 1:]),
                                           device="cpu")[0])
    want = np.asarray(jst.decode(variables, jcodes))
    got = st.decode(codes, device="cpu")
    assert got.shape == (2, 2, 6400)
    np.testing.assert_allclose(got.numpy(), want, **WAV_TOL)


def test_stereo_codebook_semantics(debug_codec):
    _, _, codec = debug_codec
    for per_timestep, k, rate in ((False, 8, 25), (True, 4, 50)):
        st = InterleaveStereoCompressionModel(codec, per_timestep=per_timestep)
        assert (st.num_codebooks, st.frame_rate, st.channels) == (k, rate, 2)
        assert st.total_codebooks == 4 and st.cardinality == 400
    wrapped = builders.get_wrapped_compression_model(
        builders.get_debug_compression_model(device="cpu"),
        {"interleave_stereo_codebooks": {"use": True, "per_timestep": False},
         "compression_model_n_q": 4})
    assert isinstance(wrapped, InterleaveStereoCompressionModel)
    assert wrapped.num_codebooks == 4 and wrapped.model.num_codebooks == 2
    with pytest.raises(AssertionError):
        wrapped.set_num_codebooks(3)


def test_debug_stereo_generate_matches_jax():
    jmg, mg = _debug_musicgen_pair("debug-stereo")
    assert mg.audio_channels == 2 and mg.lm.n_q == 8
    assert mg.lm.pattern_provider.delays == list(range(8))
    jwav, jtok = jmg.generate(TEXTS, return_tokens=True)
    wav, tok = mg.generate(TEXTS, return_tokens=True)
    assert tok.shape == (2, 8, 15) and wav.shape == (2, 2, 15 * 1280)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), **WAV_TOL)


def test_stereo_small_preset_uses_the_stereo_delays():
    """The musicgen-stereo-small pattern (8 codebooks, delays 0,0,1,1,2,2,3,3)
    on an xsmall trunk: generation gives [B, 8, T] codes."""
    from audiocraft_tpu_torch.models.presets import musicgen_lm
    lm = musicgen_lm("xsmall", n_q=8, card=64,
                     delays=builders.STEREO_SMALL_DELAYS, device="cpu").eval()
    pattern = lm.pattern_provider.get_pattern(10)
    assert len(pattern.layout) == 10 + 3 + 1
    codes = lm.generate(conditions=_attrs(ConditioningAttributes),
                        max_gen_len=10, gen=GenParams(top_k=5),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert codes.shape == (2, 8, 10) and int(codes.max()) < 64
