"""The port's JASCO serving path vs the JAX package on the same inputs and
weights (small sizes, f32, on the CPU): the U-Net transformer, the chord,
melody and drum conditioners (the drums through the debug codec), the
provider's padding, the flow-matching model and its weights' round trip,
`generate` of the debug model on the Euler and on the Dormand-Prince path
with the JAX package's initial noise injected (the same number of
function evaluations), `generate` of a small model with chords, drums and
melody, an export package read by both packages, and the entry points'
device rule. The same path on the card is tested in `test_torch_gpu.py`.

Tolerances: transformer, conditioner and vector-field outputs atol 1e-5
(f32); drum latents atol 1e-5 (the same codes, decoded); generated latents
and audio atol 1e-4 (8 Euler steps, or the adaptive solver's steps, each
adding the CFG-weighted field (weights 5 and -4); step sizes agree to f32
rounding, the accept-or-reject decisions exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import flow_matching as jfm
from audiocraft_tpu.models.jasco import JASCO as JaxJASCO
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import jasco_conditioners as jjc
from audiocraft_tpu.modules.unet_transformer import \
    UnetTransformer as JaxUnetTransformer
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import JASCO, builders, flow_matching, loaders
from audiocraft_tpu_torch.models.jasco import (CHORD_MAPPING_PATH,
                                              load_chords_mapping)
from audiocraft_tpu_torch.modules import jasco_conditioners as pjc
from audiocraft_tpu_torch.modules.conditioners import (ConditioningAttributes,
                                                       SymbolicCondition,
                                                       WavCondition)
from audiocraft_tpu_torch.modules.unet_transformer import UnetTransformer
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_loaders import CODEC_CFG
from tests.test_torch_mbd import _jax_codec, _perturbed

TOL = dict(atol=1e-5, rtol=0)
GEN_TOL = dict(atol=1e-4, rtol=0)
TEXTS = ["funky drums and bass", "sad piano"]
CHORDS = [("C", 0.0), ("G", 0.12), ("Am", 0.28)]
DEBUG_SPECS = {"description": "lut", "chords": "chords_emb"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _jax_flow_model(dim=16, flow_dim=32, chords_dim=8, num_layers=2,
                    bias_proj=True, time_embedding_dim=128):
    """The JAX debug JASCO's flow-matching module (no init)."""
    conditioners = {
        "description": jcond.LUTConditioner(n_bins=128, dim=16, output_dim=dim,
                                            tokenizer="whitespace"),
        "chords": jjc.ChordsEmbConditioner(card=194, out_dim=chords_dim)}
    fuser = jcond.ConditionFuser({"cross": ["description"], "prepend": [],
                                  "sum": [], "ignore": ["chords"],
                                  "input_interpolate": []})
    return jfm.FlowMatchingModel(
        conditioners=conditioners, fuser=fuser, dim=dim, num_heads=4,
        flow_dim=flow_dim, chords_dim=chords_dim, num_layers=num_layers,
        skip_connections=True, norm_first=True, bias_proj=bias_proj,
        time_embedding_dim=time_embedding_dim)


@pytest.fixture(scope="module")
def jascos():
    """`JASCO.get_pretrained('debug')` of the port with perturbed weights,
    and the JAX package's debug JASCO with the same weights (its converters
    carry them) and codec; both with the chord mapping of `assets/`."""
    pm = JASCO.get_pretrained("debug", device="cpu")
    _perturbed(pm.model, seed=0)
    codec, codec_vars = _jax_codec(pm.compression_model)
    params = torch_port.convert_flow_matching_state(
        _state(pm.model), num_layers=2, norm_first=True, skip_connections=True,
        conditioner_specs=DEBUG_SPECS)
    jm = JaxJASCO("debug", codec, codec_vars, _jax_flow_model(), params,
                  max_duration=1.0)
    mapping = load_chords_mapping(CHORD_MAPPING_PATH)
    pm.chords_mapping = jm.chords_mapping = mapping
    return jm, pm


def test_chords_mapping_is_the_assets_pickle():
    import pickle
    with open(CHORD_MAPPING_PATH, "rb") as f:
        assert load_chords_mapping(CHORD_MAPPING_PATH) == pickle.load(f)


@pytest.mark.parametrize("skip_connections", [True, False])
def test_unet_transformer_matches_jax(skip_connections):
    torch.manual_seed(0)
    port = _perturbed(UnetTransformer(
        16, 4, 4, dim_feedforward=64, norm_first=True, cross_attention=True,
        skip_connections=skip_connections), seed=1)
    tree = torch_port._convert_transformer_layers(
        _state(port), "", 4, cross_attention=True,
        skip_projections=skip_connections)
    jmodel = JaxUnetTransformer(d_model=16, num_heads=4, num_layers=4,
                                dim_feedforward=64, norm_first=True,
                                cross_attention=True,
                                skip_connections=skip_connections)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 11, 16).astype(np.float32)
    src = rs.randn(2, 5, 16).astype(np.float32)
    want, _ = jmodel.apply({"params": tree}, jnp.asarray(x),
                           cross_attention_src=jnp.asarray(src))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   cross_attention_src=torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_symbolic_conditioners_match_jax():
    """Chords (card 194 + the null chord) and melody salience (53)."""
    torch.manual_seed(0)
    chords = _perturbed(pjc.ChordsEmbConditioner(194, 8), seed=1)
    melody = _perturbed(pjc.MelodyConditioner(53, 8), seed=2)
    rs = np.random.RandomState(3)
    frame_chords = rs.randint(0, 195, (2, 12)).astype(np.int32)
    salience = rs.rand(2, 53, 12).astype(np.float32)
    for port, jmodel, params, sym in (
            (chords, jjc.ChordsEmbConditioner(card=194, out_dim=8),
             {"emb": {"embedding": chords.emb.weight.detach().numpy()}},
             SymbolicCondition(frame_chords=frame_chords)),
            (melody, jjc.MelodyConditioner(card=53, output_dim=8),
             {"output_proj": {
                 "kernel": melody.output_proj.weight.detach().numpy().T,
                 "bias": melody.output_proj.bias.detach().numpy()}},
             SymbolicCondition(melody=salience))):
        want, want_mask = jmodel.apply({"params": params},
                                       jcond.SymbolicCondition(*sym))
        with torch.no_grad():
            got, mask = port(port.tokenize(sym))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_drums_conditioner_matches_jax(monkeypatch):
    """A live row and a null one (length 0) of 0.4 s at 32 kHz through the
    debug codec: 10 latent frames, blurred in threes (the last group
    completed with the reversed tail)."""
    monkeypatch.delenv("DEMUCS_CHECKPOINT", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    codec = builders.get_debug_compression_model(device="cpu", seed=5)
    jcodec, jcodec_vars = _jax_codec(codec)
    kw = dict(sample_rate=32000, blurring_factor=3,
              compression_model_latent_dim=32, compression_model_framerate=25,
              segment_duration=0.4)
    torch.manual_seed(0)
    port = pjc.bind_drums_codec(_perturbed(pjc.DrumsConditioner(8, **kw), 1),
                                codec)
    jmodel = jjc.bind_drums_codec(jjc.DrumsConditioner(output_dim=8, **kw),
                                  jcodec, jcodec_vars)
    wav = np.zeros((2, 1, 12800), np.float32)
    wav[0] = np.random.RandomState(6).randn(1, 12800) * 0.1
    lengths = np.array([12800, 0])
    want_tok = jmodel.tokenize(jcond.WavCondition(
        wav, lengths, sample_rate=[32000, 32000], path=[None, None]))
    got_tok = port.tokenize(WavCondition(torch.from_numpy(wav),
                                         torch.from_numpy(lengths),
                                         [32000, 32000], [None, None]))
    assert tuple(got_tok["latents"].shape) == (2, 10, 32)
    np.testing.assert_allclose(got_tok["latents"].numpy(),
                               want_tok["latents"], **TOL)
    np.testing.assert_array_equal(got_tok["valid"].numpy(), want_tok["valid"])
    params = {"output_proj": {
        "kernel": port.output_proj.weight.detach().numpy().T,
        "bias": port.output_proj.bias.detach().numpy()}}
    want, want_mask = jmodel.apply({"params": params}, want_tok)
    with torch.no_grad():
        got, mask = port(got_tok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert not got[1].any()


SMALL_CFG = {
    "transformer_lm": {"dim": 16, "num_heads": 4, "num_layers": 2,
                       "flow_dim": 32, "norm_first": True, "bias_proj": False,
                       "time_embedding_dim": 16, "skip_connections": True,
                       "causal": False, "cross_attention": True,
                       "activation": "gelu"},
    "conditioners": {
        "description": {"model": "lut", "lut": {
            "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}},
        "chords": {"model": "chords_emb", "chords_emb": {
            "card": 194, "out_dim": 8}},
        "self_wav": {"model": "drum_latents", "drum_latents": {
            "out_dim": 8, "sample_rate": 32000, "blurring_factor": 3,
            "compression_model_latent_dim": 32,
            "compression_model_framerate": 25, "segment_duration": 0.4}},
        "melody": {"model": "melody", "melody": {"card": 53, "out_dim": 4}}},
    "fuser": {"cross": ["description"], "ignore": ["chords", "self_wav",
                                                   "melody"],
              "prepend": [], "sum": [], "input_interpolate": []},
    "classifier_free_guidance": {"inference_coef": 2.5}}


@pytest.fixture(scope="module")
def full_jascos(jascos):
    """A small JASCO with every condition (chords, drums over the debug
    codec, melody salience) in both packages, the JAX model built by the
    JAX package's `get_jasco_model` from the same config."""
    _, pm = jascos
    model = _perturbed(builders.get_jasco_model(SMALL_CFG, device="cpu",
                                                seed=5), 6)
    assert model.emb.in_features == 32 + 8 + 8 + 4
    codec, codec_vars = _jax_codec(pm.compression_model)
    params = torch_port.convert_flow_matching_state(
        _state(model), num_layers=2, norm_first=True, bias_proj=False,
        skip_connections=True, conditioner_specs={
            "description": "lut", "chords": "chords_emb", "self_wav": "drums",
            "melody": "melody"})
    jm = JaxJASCO("full", codec, codec_vars, jbuilders.get_jasco_model(
        SMALL_CFG), params, max_duration=0.4)
    port = JASCO("full", pm.compression_model, model, device="cpu")
    port.chords_mapping = jm.chords_mapping = pm.chords_mapping
    return jm, port


def test_jasco_with_drums_and_melody_matches_jax(full_jascos, monkeypatch):
    """Chords, a stereo drum waveform longer than the duration (cut, mixed
    to mono, encoded, its coarsest codes decoded, blurred) and a melody
    salience shorter than it (zero-padded); the null CFG term nulls all
    three; 3 Euler steps."""
    monkeypatch.delenv("DEMUCS_CHECKPOINT", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    jm, pm = full_jascos
    rs = np.random.RandomState(11)
    drums = (rs.randn(2, 14000) * 0.1).astype(np.float32)
    salience = rs.rand(53, 7).astype(np.float32)
    for model in (jm, pm):
        model.set_generation_params(duration=0.4, euler=True, euler_steps=3)
    _inject_jax_noise(monkeypatch, jm, (2, 10, 32))
    jwav, jlat = jm.generate(TEXTS, chords=CHORDS, drums_wav=drums,
                             melody_salience_matrix=salience,
                             return_tokens=True)
    pwav, plat = pm.generate(TEXTS, chords=CHORDS, drums_wav=drums,
                             melody_salience_matrix=salience,
                             return_tokens=True)
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), **GEN_TOL)
    np.testing.assert_allclose(pwav.numpy(), np.asarray(jwav), **GEN_TOL)


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JASCO.get_pretrained("debug")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builders.get_audioseal_base()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        builders.get_diffusion_band({"diffusion_unet": {"hidden": 8}}, 32000)


def test_flow_matching_weights_round_trip(jascos):
    """port -> JAX (the JAX package's converter) -> port (`jax_weights`);
    the chords' unused `output_proj` keeps the fresh model's values."""
    jm, pm = jascos
    fresh = builders.get_debug_jasco_model(device="cpu", seed=9).model
    jax_weights.load_flow_matching(fresh, _np(jm.params))
    for key, value in pm.model.state_dict().items():
        if "chords.output_proj" not in key:
            torch.testing.assert_close(fresh.state_dict()[key], value,
                                       rtol=0, atol=0)


def test_flow_matching_forward_matches_jax(jascos):
    """The provider's padding (chords cut or padded to 12 frames with the
    null chord), the conditions and one vector-field evaluation."""
    jm, pm = jascos
    attrs = [dict(text={"description": t},
                  chords=np.arange(12 - 5 * i + 3) % 195)
             for i, t in enumerate(TEXTS)]
    jtok = jjc.JascoConditioningProvider(
        jm.model.conditioners, sequence_length=12).tokenize([
            jcond.ConditioningAttributes(text=a["text"], symbolic={
                "chords": jcond.SymbolicCondition(frame_chords=a["chords"])})
            for a in attrs])
    ptok = pjc.JascoConditioningProvider(
        pm.model.conditioners, sequence_length=12).tokenize([
            ConditioningAttributes(text=a["text"], symbolic={
                "chords": SymbolicCondition(frame_chords=a["chords"])})
            for a in attrs])
    np.testing.assert_array_equal(ptok["chords"].frame_chords.numpy(),
                                  jtok["chords"].frame_chords)
    assert ptok["chords"].frame_chords[1, -1] == 194
    rs = np.random.RandomState(7)
    latents = rs.randn(2, 12, 32).astype(np.float32)
    t = np.array([0.1, 0.7], np.float32)
    conds = jm.model.apply(jm.params, jtok,
                           method=jfm.FlowMatchingModel.compute_conditions)
    want = jax.jit(jm.model.apply)(jm.params, jnp.asarray(latents),
                                   jnp.asarray(t), conds)
    with torch.no_grad():
        got = pm.model(torch.from_numpy(latents), torch.from_numpy(t),
                       pm.model.compute_conditions(ptok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _inject_jax_noise(monkeypatch, jm, shape):
    """The JAX JASCO's rng from PRNGKey(0); its first split draws z_0."""
    jm.rng = jax.random.PRNGKey(0)
    _, r = jax.random.split(jax.random.PRNGKey(0))
    z0 = np.asarray(jax.random.normal(r, shape))

    def injected(shape_, generator, device):
        assert tuple(shape_) == shape
        return torch.from_numpy(z0.copy()).to(device)

    monkeypatch.setattr(flow_matching, "randn", injected)


def _count_jax_evaluations(monkeypatch) -> list:
    """Count the vector-field evaluations inside the JAX package's jitted
    `odeint`, through a host callback."""
    import jax.experimental.ode as ode
    odeint, count = ode.odeint, [0]

    def counting(func, y0, t, *args, **kwargs):
        def f(y, t_, *a):
            jax.debug.callback(lambda: count.__setitem__(0, count[0] + 1))
            return func(y, t_, *a)
        return odeint(f, y0, t, *args, **kwargs)

    monkeypatch.setattr(ode, "odeint", counting)
    return count


def _count_port_evaluations(model):
    """Count the port model's forwards: one per vector-field evaluation."""
    count = [0]
    handle = model.register_forward_pre_hook(
        lambda *_: count.__setitem__(0, count[0] + 1))
    return count, handle



@pytest.mark.parametrize("euler", [True, False], ids=["euler", "dopri5"])
def test_debug_jasco_generate_matches_jax(jascos, monkeypatch, euler):
    """2 texts x 0.4 s (10 frames of 32 dims) with chords, CFG 5 on all
    conditions and -4 on none."""
    jm, pm = jascos
    for model in (jm, pm):
        model.set_generation_params(duration=0.4, euler=euler, euler_steps=8)
    _inject_jax_noise(monkeypatch, jm, (2, 10, 32))
    jax_count = _count_jax_evaluations(monkeypatch)
    port_count, handle = _count_port_evaluations(pm.model)
    try:
        jwav, jlat = jm.generate(TEXTS, chords=CHORDS, return_tokens=True)
        pwav, plat = pm.generate(TEXTS, chords=CHORDS, return_tokens=True)
    finally:
        handle.remove()
    assert tuple(pwav.shape) == (2, 1, 12800) and tuple(plat.shape) == (2, 10, 32)
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), **GEN_TOL)
    np.testing.assert_allclose(pwav.numpy(), np.asarray(jwav), **GEN_TOL)
    if euler:
        assert port_count[0] == 8
    else:
        assert port_count[0] == jax_count[0] and (port_count[0] - 2) % 6 == 0
        assert port_count[0] > 8, port_count


def test_jasco_package_loads_in_both_packages(tmp_path, jascos):
    """`state_dict.bin` (the flow model, no output bias) and
    `compression_state_dict.bin` (the debug codec), read by both packages'
    `get_pretrained`; an Euler generate agrees."""
    jm, pm = jascos
    cfg = {"transformer_lm": {"dim": 16, "num_heads": 4, "num_layers": 2,
                              "flow_dim": 32, "chords_dim": 8,
                              "norm_first": True, "bias_proj": False,
                              "time_embedding_dim": 16,
                              "skip_connections": True, "causal": False,
                              "cross_attention": True, "activation": "gelu"},
           "conditioners": {
               "description": {"model": "lut", "lut": {
                   "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}},
               "chords": {"model": "chords_emb", "chords_emb": {
                   "card": 194, "out_dim": 8}}},
           "fuser": {"cross": ["description"], "ignore": ["chords"],
                     "prepend": [], "sum": [], "input_interpolate": []},
           "classifier_free_guidance": {"inference_coef": 2.5},
           "compression_model_latent_std": 2.0,
           "dataset": {"segment_duration": 0.4}}
    model = _perturbed(builders.get_jasco_model(cfg, device="cpu", seed=3), 4)
    torch.save({"best_state": model.state_dict(), "xp.cfg": cfg},
               tmp_path / "state_dict.bin")
    torch.save({"best_state": pm.compression_model.state_dict(),
                "xp.cfg": CODEC_CFG}, tmp_path / "compression_state_dict.bin")
    loaded, _ = loaders.load_jasco_model(str(tmp_path), device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    port = JASCO.get_pretrained(str(tmp_path), device="cpu")
    theirs = JaxJASCO.get_pretrained(str(tmp_path))
    assert port.max_duration == 0.4 and port.latent_std == 2.0
    for m in (port, theirs):
        m.set_generation_params(duration=0.4, euler=True, euler_steps=3)
    theirs.rng = jax.random.PRNGKey(0)
    jwav, jlat = theirs.generate(TEXTS[:1], chords=CHORDS, return_tokens=True)
    _, r = jax.random.split(jax.random.PRNGKey(0))
    port.generator.manual_seed(0)
    z0 = np.asarray(jax.random.normal(r, (1, 10, 32)))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flow_matching, "randn",
                  lambda shape, g, d: torch.from_numpy(z0.copy()))
        pwav, plat = port.generate(TEXTS[:1], chords=CHORDS,
                                   return_tokens=True)
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), **GEN_TOL)
    np.testing.assert_allclose(pwav.numpy(), np.asarray(jwav), **GEN_TOL)


def test_chords_drums_config_builds_at_small_scale():
    """`solver/jasco/chords_drums` at `model_scale/small`: the widths the
    smoke run serves (a meta-device build: no weights are made)."""
    model = builders.get_jasco_chords_drums_model(device="meta")
    assert model.dim == 1024 and len(model.transformer.layers) == 24
    assert model.emb.in_features == 128 + 16 + 16
    assert len(model.transformer.skip_projections) == 12
    assert model.linear.bias is None and model.out_norm is not None
    drums = model.conditioners["self_wav"]
    assert drums.seq_len == 500 and drums.blurring_factor == 3
    assert model.conditioners["chords"].emb.num_embeddings == 195
