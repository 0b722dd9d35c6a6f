"""The port's Multi-Band Diffusion serving path vs the JAX package on the
same inputs and weights (small sizes, f32, on the CPU): the band splitter
(8 and 32 bands), the noise schedule and its full reverse process, the
band processor, the diffusion
U-Net (plain, BiLSTM, codec-conditioned, cross-attention and transformer
bottlenecks), a 2-band `tokens_to_wav` and `regenerate` over the debug
codec with the JAX package's Gaussian draws injected, and the bundle
loader. The same path on
the card is tested in `test_torch_gpu.py`.

Tolerances:
- betas and alpha-bars: equal (the same float64 formula);
- band splitting and the band processor: atol 1e-5 (f32 FIR filters of
  753 to 3,511 taps summed in another order);
- U-Net forwards: atol 2e-5 (f32 convolutions, group norms and LSTM
  steps);
- tokens_to_wav and regenerate: atol 2e-4 (20 reverse steps per band,
  each dividing by sqrt(alpha); then the 32-band re-EQ).
"""
import collections
import pickle
import sys
import types
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import multibanddiffusion as jmbd
from audiocraft_tpu.models import unet as junet
from audiocraft_tpu.models.encodec import EncodecModel as JaxEncodec
from audiocraft_tpu.modules import diffusion_schedule as jsched
from audiocraft_tpu.modules.seanet import SEANetDecoder as JaxDecoder
from audiocraft_tpu.modules.seanet import SEANetEncoder as JaxEncoder
from audiocraft_tpu.ops import filters as jfilters
from audiocraft_tpu.quantization import vq as jvq
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import MultiBandDiffusion, builders, loaders
from audiocraft_tpu_torch.models.multibanddiffusion import DiffusionProcess
from audiocraft_tpu_torch.models.unet import DiffusionUnet
from audiocraft_tpu_torch.modules import diffusion_schedule
from audiocraft_tpu_torch.ops import filters
from audiocraft_tpu_torch.utils import jax_weights

TOL = dict(atol=1e-5, rtol=0)
UNET_TOL = dict(atol=2e-5, rtol=0)
SCHEDULE = dict(beta_t0=1e-5, beta_t1=2.9e-2, beta_exp=7.5, num_steps=1000,
                variance="beta", clip=5.0)   # solver/diffusion/default


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A module's torch work runs in one thread (the MBD, JASCO and
    checkpoint test files import this fixture). Their CPU kernels of many
    small steps (the BiLSTM's, the FIR band filters') parallelise through
    spinning thread teams, which slow 100-fold when several test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("sample_rate,n_bands", [(32000, 8), (32000, 32),
                                                 (24000, 8)])
def test_split_bands_match_jax(sample_rate, n_bands):
    x = _seeded((2, 1, 4001), scale=0.3)
    want = np.asarray(jfilters.SplitBands(sample_rate, n_bands)(jnp.asarray(x)))
    split = filters.SplitBands(sample_rate, n_bands)
    got = split(torch.from_numpy(x)).numpy()
    assert got.shape == (n_bands, 2, 1, 4001)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(0), x, atol=1e-5)
    width = filters._lowpass_kernels(split.cutoffs).shape[1]
    assert width == {(32000, 8): 753, (32000, 32): 3511}.get(
        (sample_rate, n_bands), width)


def test_noise_schedule_matches_jax():
    ours, theirs = (diffusion_schedule.NoiseSchedule(**SCHEDULE),
                    jsched.NoiseSchedule(**SCHEDULE))
    np.testing.assert_array_equal(ours.betas, theirs.betas)
    np.testing.assert_array_equal(ours.get_alpha_bar(), theirs.get_alpha_bar())
    assert ours.get_alpha_bar(499) == theirs.get_alpha_bar(499)
    steps = np.array(list(range(1000))[::-50] + [0])
    np.testing.assert_array_equal(ours.get_alpha_bar(steps),
                                  theirs.get_alpha_bar(steps))
    sub = np.cumprod(1 - ours.betas)[steps[::-1]]
    np.testing.assert_array_equal(diffusion_schedule.betas_from_alpha_bar(sub),
                                  jsched.betas_from_alpha_bar(sub))


@pytest.mark.parametrize("variance", ["beta", "beta_tilde", "none"])
def test_full_reverse_process_matches_jax(monkeypatch, variance):
    """The full DDPM reverse process over 20 steps with a fixed linear
    noise estimate, and the JAX package's draws (one per step but step 0,
    none without variance)."""
    kw = dict(SCHEDULE, num_steps=20, variance=variance)
    ours, theirs = (diffusion_schedule.NoiseSchedule(**kw),
                    jsched.NoiseSchedule(**kw))
    initial = _seeded((2, 1, 64), seed=9)
    rng, draws = jax.random.PRNGKey(3), []
    for _ in range(19 if variance != "none" else 0):
        rng, r = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(r, (2, 1, 64))))
    monkeypatch.setattr(diffusion_schedule, "randn",
                        lambda shape, g, d: torch.from_numpy(draws.pop(0).copy()))
    want = np.asarray(theirs.generate(
        lambda x, step, c: 0.05 * (step + 1) * x, jax.random.PRNGKey(3),
        jnp.asarray(initial)))
    got = ours.generate(lambda x, step, c: 0.05 * (step + 1) * x,
                        torch.from_numpy(initial)).numpy()
    assert not draws
    np.testing.assert_allclose(got, want, **TOL)


def _processor_stats(n_bands, seed):
    rs = np.random.RandomState(seed)
    return dict(counts=np.float32(3.0),
                sum_x=(rs.randn(n_bands) * 1e-3).astype(np.float32),
                sum_x2=(rs.rand(n_bands) * 1e-2 + 1e-3).astype(np.float32),
                sum_target_x2=(rs.rand(n_bands) + 0.5).astype(np.float32))


class _OverTime(jsched.MultiBandProcessor):
    """The JAX band processor over the time axis of the JAX reverse
    process's [B, T, C] samples. The JAX package hands it that layout and
    its band splitter filters the last axis, so there the bands split the
    single channel, each sample alone; upstream and the port split time
    (ROADMAP §3)."""

    def return_sample(self, state, x):
        return jnp.swapaxes(super().return_sample(
            state, jnp.swapaxes(x, 1, 2)), 1, 2)


def _processors(sample_rate, n_bands=8, seed=0, cls=jsched.MultiBandProcessor):
    stats = _processor_stats(n_bands, seed)
    state = jsched.MBPState(**{k: jnp.asarray(v) for k, v in stats.items()})
    port = diffusion_schedule.MultiBandProcessor(n_bands, sample_rate)
    jax_weights.load_band_processor(port, state)
    return port, cls(n_bands, sample_rate), state


def test_band_processor_matches_jax():
    port, jproc, state = _processors(32000)
    x = _seeded((2, 1, 3000), seed=1, scale=0.1)
    for method in ("project_sample", "return_sample"):
        want = np.asarray(getattr(jproc, method)(state, jnp.asarray(x)))
        got = getattr(port, method)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


UNETS = {
    "plain": dict(),
    "bilstm": dict(bilstm=True, emb_all_layers=True),
    "codec": dict(bilstm=True, emb_all_layers=True, codec_dim=6),
    "cross_attention": dict(transformer=True, cross_attention=True,
                            codec_dim=6),
    "transformer": dict(transformer=True, emb_all_layers=True),
}


def _perturbed(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded noise on every parameter (norms and biases included), so a
    swapped or transposed weight shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return module.eval()


def _unets(kw, seed=0, num_steps=50):
    """The port's `DiffusionUnet` (hidden 8, depth 2: channels 8 and 16)
    with seeded weights, and the JAX package's with the same weights,
    carried by the JAX package's converter."""
    common = dict(chin=1, hidden=8, depth=2, growth=2.0, kernel=4, stride=2,
                  norm_groups=4, num_steps=num_steps)
    torch.manual_seed(seed)
    port = _perturbed(DiffusionUnet(**common, **kw), seed)
    flags = dict(emb_all_layers=kw.get("emb_all_layers", False),
                 bilstm=kw.get("bilstm", False),
                 use_transformer=kw.get("transformer", False),
                 cross_attention=kw.get("cross_attention", False),
                 codec_dim=kw.get("codec_dim"))
    params = torch_port.convert_diffusion_unet(
        {k: v.numpy() for k, v in port.state_dict().items()}, depth=2,
        **flags)
    return junet.DiffusionUnet(**common, **flags), params, port


def test_diffusion_unet_weights_round_trip():
    """port -> JAX (the JAX package's converter) -> port (`jax_weights`)."""
    for kw in UNETS.values():
        _, params, port = _unets(kw, seed=1)
        fresh = DiffusionUnet(chin=1, hidden=8, depth=2, growth=2.0, kernel=4,
                              stride=2, norm_groups=4, num_steps=50, **kw)
        jax_weights.load_diffusion_unet(fresh, _np(params))
        for key, value in port.state_dict().items():
            torch.testing.assert_close(fresh.state_dict()[key], value,
                                       rtol=0, atol=0)


@pytest.mark.parametrize("variant", list(UNETS))
def test_diffusion_unet_matches_jax(variant):
    """A per-row step and an odd length (37: both encoders right-pad)."""
    jmodel, params, port = _unets(UNETS[variant])
    x = _seeded((2, 37, 1), seed=2)
    cond = _seeded((2, 7, 6), seed=3) if "codec_dim" in UNETS[variant] else None
    step = np.array([3, 41])
    want = np.asarray(jmodel.apply(
        params, jnp.asarray(x), jnp.asarray(step),
        condition=None if cond is None else jnp.asarray(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2), torch.as_tensor(step),
                   None if cond is None
                   else torch.from_numpy(cond).transpose(1, 2))
    assert tuple(got.shape) == (2, 1, 37)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **UNET_TOL)


def _jax_codec(codec):
    """The JAX debug codec (25 Hz at 32 kHz) with the port codec's weights,
    carried by the JAX package's converter (no JAX init)."""
    kw = dict(n_filters=4, n_residual_layers=1, dimension=32,
              ratios=(10, 8, 16))
    model = JaxEncodec(JaxEncoder(**kw), JaxDecoder(**kw),
                       jvq.ResidualVectorQuantizer(dimension=32, bins=400,
                                                   n_q=4, kmeans_init=False),
                       frame_rate=25, sample_rate=32000, channels=1)
    state = {k: v.numpy() for k, v in codec.state_dict().items()}
    return model, torch_port.convert_encodec_state(
        state, ratios=(10, 8, 16), n_residual_layers=1, lstm=0, n_q=4)


class _Jitted:
    """A JAX U-Net whose `apply` is one jitted program (the step traced)."""

    def __init__(self, model):
        self._apply = jax.jit(lambda params, x, step, condition: model.apply(
            params, x, step, condition=condition))

    def apply(self, params, x, step, condition=None):
        return self._apply(params, x, jnp.asarray(step), condition)


def _jax_draws(n_bands, shape):
    """The Gaussian draws of the JAX package's `MultiBandDiffusion.generate`
    in order: per band the initial noise, then one draw per reverse step
    but the last two of the 21-entry step list."""
    rng, draws = jax.random.PRNGKey(0), []
    for _ in range(n_bands):
        rng, r = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(r, shape)))
        rng, r_rev = jax.random.split(rng)
        for _ in range(19):
            r_rev, r = jax.random.split(r_rev)
            draws.append(np.asarray(jax.random.normal(r, shape)))
    return draws


@pytest.fixture(scope="module")
def mbds():
    """2 bands over the debug codec (32-dim latents, 25 Hz): each a BiLSTM
    U-Net with the codec condition and an 8-band processor, which the JAX
    side applies over time (`_OverTime`); the JAX U-Nets jitted."""
    codec = builders.get_debug_compression_model(device="cpu", seed=3)
    jcodec, jcodec_vars = _jax_codec(codec)
    jdps, dps = [], []
    for band in range(2):
        jmodel, params, port = _unets(
            dict(bilstm=True, emb_all_layers=True, codec_dim=32), seed=band,
            num_steps=1000)
        port_proc, jproc, state = _processors(32000, seed=band, cls=_OverTime)
        jdps.append(jmbd.DiffusionProcess(
            _Jitted(jmodel), params,
            jsched.NoiseSchedule(sample_processor=jproc, **SCHEDULE), state))
        dps.append(DiffusionProcess(port, diffusion_schedule.NoiseSchedule(
            sample_processor=port_proc, **SCHEDULE)))
    return (jmbd.MultiBandDiffusion(jdps, jcodec, jcodec_vars),
            MultiBandDiffusion(dps, codec, device="cpu"))


@pytest.mark.parametrize("entry", ["tokens_to_wav", "regenerate"])
def test_mbd_matches_jax_with_its_noise(mbds, monkeypatch, entry):
    """`tokens_to_wav` on 3 frames of codes, and `regenerate` on 1,920
    samples at 16 kHz (resampled to the 3,840 of 3 frames at 32 kHz,
    encoded, diffused); both with the JAX package's draws."""
    jm, pm = mbds
    jm.rng = jax.random.PRNGKey(0)
    draws = _jax_draws(2, (2, 3 * 1280, 1))

    def injected(shape, generator, device):
        draw = draws.pop(0)
        assert draw.size == int(np.prod(shape))
        return torch.from_numpy(draw.reshape(shape).copy()).to(device)

    monkeypatch.setattr(diffusion_schedule, "randn", injected)
    if entry == "tokens_to_wav":
        tokens = np.random.RandomState(4).randint(0, 400, (2, 4, 3))
        want = np.asarray(jm.tokens_to_wav(jnp.asarray(tokens, jnp.int32)))
        got = pm.tokens_to_wav(torch.from_numpy(tokens)).numpy()
    else:
        wav = _seeded((2, 1, 1920), seed=8, scale=0.2)
        want = np.asarray(jm.regenerate(jnp.asarray(wav), 16000))
        got = pm.regenerate(torch.from_numpy(wav), 16000).numpy()
    assert not draws and got.shape == (2, 1, 3 * 1280)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _omegaconf_standins(monkeypatch):
    """Classes under omegaconf's module and class names, for pickling a
    config laid out as OmegaConf's: a `DictConfig` with metadata, a parent
    and a `_content` of `AnyNode`s (lists as nodes of nodes)."""
    monkeypatch.setitem(sys.modules, "omegaconf", types.ModuleType("omegaconf"))
    classes = {}
    for module, name in (("omegaconf.dictconfig", "DictConfig"),
                         ("omegaconf.nodes", "AnyNode"),
                         ("omegaconf.base", "Metadata")):
        mod = types.ModuleType(module)
        classes[name] = type(name, (), {"__module__": module})
        setattr(mod, name, classes[name])
        monkeypatch.setitem(sys.modules, module, mod)

    def metadata():
        m = classes["Metadata"]()
        m.__dict__.update(ref_type=tp.Any, object_type=dict, optional=True,
                          key=None, flags={})
        return m

    def node(value, parent):
        n = classes["AnyNode"]()
        n.__dict__.update(_metadata=metadata(), _parent=parent, _val=value)
        return n

    def dictconfig(content, parent=None):
        d = classes["DictConfig"]()
        d.__dict__.update(_metadata=metadata(), _parent=parent, _content={
            k: dictconfig(v, d) if isinstance(v, dict) else
            node([node(x, d) for x in v] if isinstance(v, list) else v, d)
            for k, v in content.items()})
        return d

    return dictconfig


BAND_CFG = {"channels": 1, "sample_rate": 32000,
            "diffusion_unet": dict(hidden=8, depth=2, growth=2, kernel=4,
                                   stride=2, norm_groups=4, res_blocks=1,
                                   emb_all_layers=True, bilstm=True,
                                   codec_dim=6, transformer=False,
                                   cross_attention=False, dropout=0.0),
            "schedule": dict(SCHEDULE, num_steps=50, repartition="power"),
            "processor": {"name": "multi_band_processor", "use": True,
                          "n_bands": 8, "num_samples": 10000},
            "datasource": {"train": "egs/music/train"},
            "metrics": {"stages": [1, 2]}}


def test_diffusion_bundle_loads_and_matches_jax(tmp_path, monkeypatch):
    """A 2-band bundle as upstream writes it (a pickled `DictConfig` per
    band, the processor's statistics with julius's filter bank) loads
    without omegaconf, and each band equals the JAX package's model built
    by its converters from the same state."""
    states = []
    for band in range(2):
        model, schedule = builders.get_diffusion_band(BAND_CFG, 32000,
                                                      device="cpu", seed=band)
        jax_weights.load_band_processor(schedule.sample_processor,
                                        jsched.MBPState(**{
                                            k: jnp.asarray(v) for k, v in
                                            _processor_stats(8, band).items()}))
        proc = dict(schedule.sample_processor.state_dict())
        proc["split_bands.lowpass.filters"] = torch.zeros(7, 1, 5)
        states.append((model.state_dict(), proc))
    path = tmp_path / "mbd_musicgen_32khz.th"
    with monkeypatch.context() as m:
        dictconfig = _omegaconf_standins(m)
        torch.save({"sample_rate": 32000, "n_bands": 2,
                    **{i: {"cfg": dictconfig(BAND_CFG),
                           "model_state": states[i][0],
                           "processor_state": states[i][1]}
                       for i in range(2)}}, path)
    assert "omegaconf" not in sys.modules
    models, schedules, cfgs, sample_rate = loaders.load_diffusion_models(
        str(tmp_path), filename="mbd_*.th", device="cpu")
    assert sample_rate == 32000 and len(models) == 2 and cfgs[0] == BAND_CFG
    assert "omegaconf" not in sys.modules
    x = _seeded((2, 37, 1), seed=5)
    cond = _seeded((2, 7, 6), seed=6)
    for band, (model, schedule) in enumerate(zip(models, schedules)):
        src = {k: v.numpy() for k, v in states[band][0].items()}
        jmodel = junet.DiffusionUnet(chin=1, num_steps=50, hidden=8, depth=2,
                                     growth=2, kernel=4, stride=2,
                                     norm_groups=4, emb_all_layers=True,
                                     bilstm=True, codec_dim=6)
        params = torch_port.convert_diffusion_unet(
            src, depth=2, emb_all_layers=True, bilstm=True, codec_dim=6)
        want = np.asarray(jmodel.apply(params, jnp.asarray(x), 7,
                                       condition=jnp.asarray(cond)))
        with torch.no_grad():
            got = model(torch.from_numpy(x).transpose(1, 2), 7,
                        torch.from_numpy(cond).transpose(1, 2))
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   **UNET_TOL)
        state = torch_port.convert_mbp_state(
            {k: v.numpy() for k, v in states[band][1].items()})
        wav = _seeded((1, 1, 2000), seed=7, scale=0.1)
        np.testing.assert_allclose(
            schedule.sample_processor.return_sample(
                torch.from_numpy(wav)).numpy(),
            np.asarray(jsched.MultiBandProcessor(8, 32000).return_sample(
                state, jnp.asarray(wav))), **TOL)


def test_diffusion_bundle_with_another_global_is_refused(tmp_path):
    path = tmp_path / "bad.th"
    torch.save({"sample_rate": 32000, "n_bands": 1,
                0: {"cfg": collections.Counter(a=1), "model_state": {},
                    "processor_state": {}}}, path)
    with pytest.raises(pickle.UnpicklingError, match="collections.Counter"):
        loaders.load_diffusion_models(str(path), device="cpu")
