"""The port's AudioSeal serving path vs the JAX package on the same inputs
and weights (small widths, f32, on the CPU): the watermark generator with
and without a message, the watermarked audio, the detector, the weights'
round trip through both packages' converters, and the snapshot loader
(read by both packages). The same path on the card is tested in
`test_torch_gpu.py`.

Tolerance: atol 1e-5 on watermarks, audio and detector outputs (f32
weight-normed convolutions and LSTMs); detection probabilities sum to 1
within 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import loaders as jloaders
from audiocraft_tpu.models import watermark as jwm
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import (AudioSeal, AudioSealDetector,
                                         AudioSealWM, builders, loaders)
from audiocraft_tpu_torch.utils import jax_weights

TOL = dict(atol=1e-5, rtol=0)
SMALL = dict(nbits=4, dimension=8, n_filters=4, n_residual_layers=1, lstm=1,
             ratios=(4, 2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(batch=2, T=203, seed=0):
    return (np.random.RandomState(seed).randn(batch, 1, T) * 0.1).astype(
        np.float32)


def _states(model: AudioSeal):
    return ({k: v.numpy() for k, v in model.generator.state_dict().items()},
            {k: v.numpy() for k, v in model.detector.state_dict().items()})


def _models(seed=0, output_dim=6):
    """The port's AudioSeal with seeded, perturbed weights, and the JAX
    package's with the same weights through its converters."""
    kw = dict(SMALL)
    torch.manual_seed(seed)
    port = AudioSeal(AudioSealWM(**kw), AudioSealDetector(
        output_dim=output_dim, **kw), device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in list(port.generator.parameters()) + list(
                port.detector.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    gen, det = _states(port)
    conv = dict(ratios=kw["ratios"], n_residual_layers=1, lstm=1)
    params = {"generator": torch_port.convert_audioseal_generator(gen, **conv),
              "detector": torch_port.convert_audioseal_detector(det, **conv)}
    jmodel = jwm.AudioSeal(jwm.AudioSealWM(**kw), jwm.AudioSealDetector(
        output_dim=output_dim, **kw))
    return port, jmodel, params


@pytest.fixture(scope="module")
def models():
    return _models()


def test_audioseal_weights_round_trip(models):
    """port -> JAX (the JAX package's converters) -> port (`jax_weights`)."""
    port, _, params = models
    fresh = AudioSeal(AudioSealWM(**SMALL),
                      AudioSealDetector(output_dim=6, **SMALL), device="cpu")
    jax_weights.load_audioseal(fresh, _np(params))
    for ours, theirs in zip(_states(fresh), _states(port)):
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])


@pytest.mark.parametrize("with_message", [False, True])
def test_watermark_matches_jax(models, with_message):
    port, jmodel, params = models
    x = _audio()
    message = (np.random.RandomState(1).randint(0, 2, (2, 4))
               if with_message else None)
    jmsg = None if message is None else jnp.asarray(message)
    pmsg = None if message is None else torch.from_numpy(message)
    want = np.asarray(jax.jit(jmodel.get_watermark)(params, jnp.asarray(x),
                                                    jmsg))
    got = port.get_watermark(torch.from_numpy(x), pmsg).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(jax.jit(jmodel.forward)(params, jnp.asarray(x), jmsg,
                                              alpha=0.5))
    got = port.forward(torch.from_numpy(x), pmsg, alpha=0.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if with_message:   # the message moves the watermark
        zero = port.get_watermark(torch.from_numpy(x)).numpy()
        assert np.abs(zero - port.get_watermark(torch.from_numpy(x),
                                                pmsg).numpy()).max() > 1e-4


def test_detector_matches_jax(models):
    port, jmodel, params = models
    x = _audio(seed=2)
    want = np.asarray(jax.jit(jmodel.detect_watermark)(params,
                                                       jnp.asarray(x)))
    got = port.detect_watermark(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2 + 4, 203)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:, :2].sum(1), 1.0, atol=1e-6)


def test_audioseal_snapshot_loads_in_both_packages(tmp_path, monkeypatch,
                                                   models):
    """`generator_<name>.pth` / `detector_<name>.pth` ({'model': state})
    with a JSON config, read by both loaders from AUDIOCRAFT_CACHE_DIR."""
    port, _, _ = models
    snapshot = tmp_path / "facebook" / "audioseal"
    snapshot.mkdir(parents=True)
    torch.save({"model": port.generator.state_dict()},
               snapshot / "generator_small.pth")
    torch.save({"model": port.detector.state_dict()},
               snapshot / "detector_small.pth")
    (snapshot / "small.json").write_text(json.dumps({
        "nbits": 4, "detector": {"output_dim": 6},
        "seanet": {"dimension": 8, "n_filters": 4, "n_residual_layers": 1,
                   "lstm": 1, "ratios": [4, 2]}}))
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path))
    loaded = AudioSeal.get_pretrained("small", device="cpu")
    jmodel, jparams = jloaders.load_audioseal_models("facebook/audioseal",
                                                     filename="small")
    x = _audio(seed=3)
    np.testing.assert_allclose(
        loaded.get_watermark(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jmodel.get_watermark)(jparams, jnp.asarray(x))),
        **TOL)
    np.testing.assert_allclose(
        loaded.detect_watermark(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jmodel.detect_watermark)(jparams,
                                                    jnp.asarray(x))), **TOL)
    with pytest.raises(FileNotFoundError):
        loaders.load_audioseal_models("facebook/audioseal", filename="base",
                                      device="cpu")


def test_audioseal_base_widths():
    """The full-width builder's model at the released `base` widths."""
    model = builders.get_audioseal_base(device="cpu")
    gen = model.generator
    assert gen.nbits == 16 and gen.encoder.dimension == 128
    assert gen.encoder.ratios == (8, 5, 4, 2) and gen.encoder.n_filters == 32
    head = model.detector.detector[1]
    assert (head.in_channels, head.out_channels) == (32, 18)
    assert model.detector.detector[0].reverse_convolution.stride == (320,)
