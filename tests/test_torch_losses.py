"""The port's losses of codec training (`audiocraft_tpu_torch/losses/`,
`ops/stft.py`'s mel filterbank and spectrogram) against the JAX package on
the CPU, on seeded numpy inputs: each loss's value and its gradient with
respect to its first input, and the balancer over two calls.

Tolerances: the mel filterbank equal (the same f64 numpy formula, cast to
f32); mel spectrograms rtol 1e-5 / atol 1e-6 (f32 FFTs and products in
another order); loss values rtol 1e-5 (1e-4 for the log-spectral ones,
whose floors amplify f32 rounding); gradients within 1e-4 of their largest
entry (5e-4 for the log-spectral ones, whose 1 / magnitude grows
where a bin is near its floor); the balancer's out gradient within 1e-4
of its largest entry (the msspec gradient's f32 rounding), its effective
loss, EMA sums and count rtol 1e-6. The JAX side runs jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu import losses as jlosses
from audiocraft_tpu.ops import stft as jstft
from audiocraft_tpu_torch import losses as tlosses
from audiocraft_tpu_torch.ops import stft as tstft
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

SR = 16000


def _pair(seed, shape=(2, 1, 3000), scale=0.3):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * scale).astype(np.float32)
    y = (x + rs.randn(*shape) * scale * 0.5).astype(np.float32)
    return x, y


def _check(jax_fn, port_fn, x, y, rtol=1e-5, gtol=1e-4):
    """Value and gradient wrt x of a loss (x, y) -> scalar in both."""
    want, want_grad = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(x),
                                                           jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_fn(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=0,
                               atol=gtol * np.abs(want_grad).max())


@pytest.mark.parametrize("htk, norm, f_min, f_max", [
    (True, None, 0.0, None), (True, "slaney", 64.0, 7000.0),
    (False, None, 0.0, None), (False, "slaney", 20.0, None)])
def test_mel_filters_match_jax(htk, norm, f_min, f_max):
    want = jstft.mel_filters(SR, 512, 40, f_min, f_max, htk, norm)
    got = tstft.mel_filters(SR, 512, 40, f_min, f_max, htk, norm)
    assert got.shape == (257, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center, normalized", [(True, False), (False, True)])
def test_mel_spectrogram_matches_jax(center, normalized):
    x, _ = _pair(0, (2, 2000))
    want = jstft.mel_spectrogram(jnp.asarray(x), SR, 256, 64, n_mels=24,
                                 f_min=30.0, center=center,
                                 normalized=normalized)
    got = tstft.mel_spectrogram(torch.from_numpy(x), SR, 256, 64, n_mels=24,
                                f_min=30.0, center=center,
                                normalized=normalized)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("segment, overlap", [(None, 0.5), (0.05, 0.5),
                                              (0.03, 0.25)])
def test_sisnr_matches_jax(segment, overlap):
    x, y = _pair(1)
    kw = dict(sample_rate=SR, segment=segment, overlap=overlap)
    _check(jlosses.SISNR(**kw), tlosses.SISNR(**kw), x, y)


@pytest.mark.parametrize("kind", ["stft", "stft_normalized", "mrstft",
                                  "sc", "mag"])
def test_stft_losses_match_jax(kind):
    x, y = _pair(2)
    small = dict(n_ffts=(256, 128), hop_lengths=(64, 30),
                 win_lengths=(200, 100), factor_sc=0.5, factor_mag=0.5)
    if kind == "mrstft":
        pair = (jlosses.MRSTFTLoss(**small), tlosses.MRSTFTLoss(**small))
    elif kind in ("sc", "mag"):
        i = 0 if kind == "sc" else 1
        pair = tuple(
            (lambda a, b, m=m: m.STFTLosses(256, 64, 200)(a, b)[i])
            for m in (jlosses, tlosses))
    else:
        kw = dict(n_fft=256, hop_length=64, win_length=200,
                  normalized=kind == "stft_normalized")
        pair = (jlosses.STFTLoss(**kw), tlosses.STFTLoss(**kw))
    _check(*pair, x, y, rtol=1e-4, gtol=5e-4)


@pytest.mark.parametrize("kind", ["wrapper_log", "wrapper_linear", "mel_l1",
                                  "msspec", "msspec_alphas_unnormalized"])
def test_mel_losses_match_jax(kind):
    x, y = _pair(3, (2, 2, 3001))
    if kind.startswith("wrapper"):
        kw = dict(n_fft=256, hop_length=64, n_mels=16, sample_rate=SR,
                  f_min=64.0, log=kind == "wrapper_log")
        want = jlosses.MelSpectrogramWrapper(**kw)(jnp.asarray(x))
        got = tlosses.MelSpectrogramWrapper(**kw)(torch.from_numpy(x))
        assert tuple(got.shape) == want.shape == (2, 32, -(-3001 // 64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        return
    if kind == "mel_l1":
        kw = dict(sample_rate=SR, n_fft=256, hop_length=64, win_length=256,
                  n_mels=16, f_min=64.0)
        pair = (jlosses.MelSpectrogramL1Loss(**kw),
                tlosses.MelSpectrogramL1Loss(**kw))
    else:
        kw = dict(sample_rate=SR, range_start=6, range_end=9, n_mels=8,
                  f_min=64.0, normalized=kind == "msspec",
                  alphas=kind != "msspec")
        pair = (jlosses.MultiScaleMelSpectrogramLoss(**kw),
                tlosses.MultiScaleMelSpectrogramLoss(**kw))
    _check(*pair, x, y, rtol=1e-4, gtol=5e-4)


@pytest.mark.parametrize("balance_grads", [True, False])
@pytest.mark.parametrize("per_batch_item", [True, False])
def test_balancer_matches_jax_over_two_calls(balance_grads, per_batch_item):
    """Two `backward`s of three losses of the output (their gradients taken
    by each package), the EMA state carried: the out gradient, the
    effective loss, the ratios and the state after each."""
    weights = {"l1": 0.1, "msspec": 2.0, "adv": 4.0}
    kw = dict(balance_grads=balance_grads, per_batch_item=per_batch_item,
              ema_decay=0.9, monitor=True)
    jbal = jlosses.Balancer(dict(weights), **kw)
    tbal = tlosses.Balancer(dict(weights), **kw)
    msspec = dict(sample_rate=SR, range_start=6, range_end=8, n_mels=8)
    jms = jlosses.MultiScaleMelSpectrogramLoss(**msspec)
    tms = tlosses.MultiScaleMelSpectrogramLoss(**msspec)
    state = jbal.init_state()
    for call in range(2):
        x, ref = _pair(10 + call, (3, 1, 2000))
        jref = jnp.asarray(ref)
        fns = {"l1": lambda y: jnp.mean(jnp.abs(y - jref)),
               "msspec": lambda y: jms(y, jref),
               "adv": lambda y: -jnp.mean(jnp.tanh(y) * jref)}
        out_grad, eff, losses, state, metrics = jax.jit(
            lambda a, s: jbal.backward(fns, a, s))(jnp.asarray(x), state)
        y = torch.from_numpy(x).requires_grad_(True)
        tref = torch.from_numpy(ref)
        tlosses_ = {"l1": (y - tref).abs().mean(), "msspec": tms(y, tref),
                    "adv": -(torch.tanh(y) * tref).mean()}
        got_eff, got_metrics = tbal.backward(tlosses_, y)
        out_grad = np.asarray(out_grad)
        np.testing.assert_allclose(y.grad.numpy(), out_grad, rtol=0,
                                   atol=1e-4 * np.abs(out_grad).max())
        np.testing.assert_allclose(got_eff.item(), float(eff), rtol=1e-6)
        assert set(got_metrics) == set(metrics) == {
            f"ratio_{k}" for k in weights}
        for k, v in metrics.items():
            np.testing.assert_allclose(got_metrics[k].item(), float(v),
                                       rtol=1e-6)
        np.testing.assert_allclose(tbal.count.item(), float(state.count),
                                   rtol=1e-6)
        for k in weights:
            np.testing.assert_allclose(tbal.avg[k].item(),
                                       float(state.avg[k]), rtol=1e-6)
    assert float(state.count) == pytest.approx(1.9)
