"""AudioSeal training of the port (`metrics/miou.py`, `losses/wmloss.py`,
`losses/loudnessloss.py`, `modules/watermark.py`, `utils/audio_effects.py`,
`solvers/watermark.py`) against the JAX package on the CPU, on the same
seeded numpy inputs:

- `calculate_miou`; both watermark losses in every branch (full and masked
  detection; bce, mse and no message bits);
- the biquads (the chunked exact form) against the JAX `lax.scan`, values
  and gradients; `basic_loudness` and the three loudness ratios with their
  gradients;
- `pad` and `mix` with the JAX package's draws given; each of the 13
  effects the port has (the JAX package's draws injected) and
  `compress_with_encodec`; `select_audio_effects`;
- two steps of `WatermarkSolver` at `tests/models/test_solvers.py`'s widths
  (4 bits, SEANet 16 / 2 filters, ratios 8-4, 0.2 s at 16 kHz, msspec
  6-8, TF loudness over 2 bands of 0.1 s) against the JAX step on the same
  weights (the port's, carried by the JAX package's converters) and draws:
  a pad mask and a full mask, the `random_noise` attack with the noise JAX
  froze into its compiled step; every metric, every gradient, the balancer
  and the parameters after Adam; then `evaluate`;
- the registry builds `solver=watermarking` from `solver/watermark/default`
  with `dataset.segment_duration=1.0`; a null segment raises `TypeError` in
  both packages; an mp3 weight raises (slice H); `speed` raises in both
  steps (the length changes).

Tolerances: the biquads in f64 against the JAX scan in f64 rtol 1e-10, and
the port's f32 against that exact scan within 1e-5 of the signal's peak
(the JAX scan's own f32 rounding is 2e-5 there on the 38 Hz highpass, so
f32 against f32 is held at 5e-5); loudness and ratios and their gradients
rtol 1e-4 (max-abs scaled); losses and effects atol 1e-6 (filters and
resampling 1e-5); solver metrics rtol 1e-4; each gradient's L2 error within
2e-3 of its L2 norm plus 1e-6 of the largest gradient's (a weight-normed
direction's gradient can be rounding alone, 1e-10); parameters after Adam
within 2 x lr of JAX's (a step moves a weight by about lr x sign(g), which
f32 rounding of a near-zero g may flip); the balancer's state rtol 1e-4; `evaluate`'s metrics equal
(thresholded detections) where the detector's margin exceeds rounding.
"""
import random as pyrandom

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu.losses import loudnessloss as jloud
from audiocraft_tpu.losses import wmloss as jwml
from audiocraft_tpu.metrics.miou import calculate_miou as jmiou
from audiocraft_tpu.models import watermark as jwm
from audiocraft_tpu.modules import watermark as jwmod
from audiocraft_tpu.solvers import watermark as jsolver_mod
from audiocraft_tpu.utils import audio_effects as jfx
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.config import load_config
from audiocraft_tpu_torch.losses import loudnessloss as ploud
from audiocraft_tpu_torch.losses import wmloss as pwml
from audiocraft_tpu_torch.metrics import calculate_miou
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.modules import watermark as pwmod
from audiocraft_tpu_torch.solvers import get_solver
from audiocraft_tpu_torch.solvers import watermark as psolver_mod
from audiocraft_tpu_torch.utils import audio_effects as pfx
from tests.test_torch_mbd import _jax_codec, _one_torch_thread  # noqa: F401

SR = 16000
CFG = {"solver": "watermarking", "seed": 0, "sample_rate": SR,
       "audioseal": {"nbits": 4, "dimension": 16, "n_filters": 2,
                     "ratios": [8, 4]},
       "dataset": {"segment_duration": 0.2},
       "msspec": {"range_start": 6, "range_end": 8, "n_mels": 8},
       "tf_loudnessratio": {"segment": 0.1, "n_bands": 2}}
T = int(SR * 0.2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(B=2, T=T, seed=0, scale=0.1):
    return (np.random.RandomState(seed).randn(B, 1, T) * scale).astype(
        np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, rtol)


# ------------------------------------------------------------ metric, losses
def test_calculate_miou():
    rs = np.random.RandomState(1)
    pred, truth = rs.rand(3, 40), rs.rand(3, 40) > 0.5
    truth[2] = False
    pred[2] = 0.0   # an empty union
    assert calculate_miou(pred, truth) == pytest.approx(jmiou(pred, truth),
                                                        abs=1e-12)
    assert calculate_miou(torch.from_numpy(pred), truth) == pytest.approx(
        jmiou(pred, truth), abs=1e-12)


def _detector_out(seed, B=2, nbits=3, T=50):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, 2 + nbits, T).astype(np.float32)
    probs = np.exp(logits[:, :2]) / np.exp(logits[:, :2]).sum(1, keepdims=True)
    return np.concatenate([probs, logits[:, 2:]], 1).astype(np.float32)


@pytest.mark.parametrize("branch", ["full", "masked"])
def test_detection_loss_matches_jax(branch):
    pos, neg = _detector_out(0), _detector_out(1)
    mask = np.ones((2, 1, 50), np.float32)
    if branch == "masked":
        mask[0, :, 10:30] = 0
    want = float(jwml.WMDetectionLoss(1.0, 0.7)(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask)))
    loss = pwml.WMDetectionLoss(1.0, 0.7)
    args = (torch.from_numpy(pos), torch.from_numpy(neg),
            torch.from_numpy(mask))
    assert float(loss(*args)) == pytest.approx(want, abs=1e-6)
    assert float(loss(*args, full=branch == "full")) == pytest.approx(
        want, abs=1e-6)


@pytest.mark.parametrize("loss_type, nbits", [("bce", 3), ("mse", 3),
                                              ("bce", 0)])
def test_decoding_loss_matches_jax(loss_type, nbits):
    pos, neg = _detector_out(2, nbits=nbits), _detector_out(3, nbits=nbits)
    mask = np.ones((2, 1, 50), np.float32)
    mask[1, :, :20] = 0
    msg = np.random.RandomState(4).randint(0, 2, (2, nbits))
    want = float(jwml.WMMbLoss(0.1, loss_type)(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask),
        jnp.asarray(msg)))
    got = float(pwml.WMMbLoss(0.1, loss_type)(
        torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(mask),
        torch.from_numpy(msg)))
    assert got == pytest.approx(want, abs=1e-6, rel=1e-6)


# ------------------------------------------------------------------ biquads
BIQUADS = {
    "treble": (lambda m, x: m.treble_biquad(x, SR, 4.0, 1500.0,
                                            1 / np.sqrt(2))),
    "highpass": (lambda m, x: m.highpass_biquad(x, SR, 38.0, 0.5)),
    # T shorter than a chunk, and a length that is not a multiple of it
    "biquad": (lambda m, x: m.biquad(x[..., :37], 0.3, -0.2, 0.1, 1.2, -0.5,
                                     0.25)),
}


@pytest.mark.parametrize("name", list(BIQUADS))
def test_biquad_matches_jax_scan(name):
    f = BIQUADS[name]
    x = _audio(3, 8000, seed=5, scale=0.3)
    w = np.random.RandomState(6).randn(*x.shape)
    with jax.enable_x64(True):
        x64 = jnp.asarray(x, jnp.float64)
        exact = np.asarray(jax.jit(lambda a: f(jloud, a))(x64))
        exact_grad = np.asarray(jax.grad(lambda a: jnp.sum(
            f(jloud, a) * jnp.asarray(w[..., :f(jloud, a).shape[-1]])))(x64))
    want32 = np.asarray(jax.jit(lambda a: f(jloud, a))(jnp.asarray(x)))
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    got64 = f(ploud, xt)
    (got64 * torch.from_numpy(w[..., :got64.shape[-1]])).sum().backward()
    _close(got64.detach().numpy(), exact, 1e-10)
    _close(xt.grad.numpy(), exact_grad, 1e-10)
    got32 = f(ploud, torch.from_numpy(x)).numpy()
    _close(got32, exact, 1e-5)
    _close(got32, want32, 5e-5)


def _loss_and_grad_jax(fn, out, ref):
    value, grad = jax.jit(jax.value_and_grad(lambda o: jnp.sum(fn(
        o, jnp.asarray(ref)))))(jnp.asarray(out))
    return np.asarray(value), np.asarray(grad)


def _loss_and_grad_port(fn, out, ref):
    o = torch.from_numpy(out).requires_grad_(True)
    value = fn(o, torch.from_numpy(ref)).sum()
    value.backward()
    return value.detach().numpy(), o.grad.numpy()


@pytest.mark.parametrize("name", ["basic_loudness", "floudness", "tloudness",
                                  "tfloudness"])
def test_loudness_losses_match_jax(name):
    ref = _audio(2, 4000, seed=7, scale=0.3)
    out = ref + _audio(2, 4000, seed=8, scale=0.01)
    if name == "basic_loudness":
        fns = [lambda m, o, r: m.basic_loudness(o, SR) * (1 + 0 * r.sum())]
    else:
        cls = {"floudness": "FLoudnessRatio", "tloudness": "TLoudnessRatio",
               "tfloudness": "TFLoudnessRatio"}[name]
        kw = dict(segment=0.1) if name != "floudness" else {}
        if name != "tloudness":
            kw["n_bands"] = 2
        if name == "tfloudness":
            kw["temperature"] = 0.5
        fns = [lambda m, o, r: getattr(m, cls)(SR, **kw)(o, r)]
    for fn in fns:
        want = _loss_and_grad_jax(lambda o, r: fn(jloud, o, r), out, ref)
        got = _loss_and_grad_port(lambda o, r: fn(ploud, o, r), out, ref)
        _close(got[0], want[0], 1e-4)
        _close(got[1], want[1], 1e-4)


# ---------------------------------------------------------- pad, mix, effects
@pytest.mark.parametrize("central", [False, True])
def test_pad_matches_jax(central):
    x = _audio(3, 400, seed=9)
    np.random.seed(11)
    starts = np.random.randint(0, int(0.33 * 400), size=(3,))
    ends = np.random.randint(int(0.66 * 400), 400, size=(3,))
    np.random.seed(11)
    want = jwmod.pad(x, central=central)
    got = pwmod.pad(torch.from_numpy(x), central=central, starts=starts,
                    ends=ends)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # drawn from a generator: windows inside their ranges
    _, pred = pwmod.pad(torch.from_numpy(x),
                        generator=torch.Generator().manual_seed(0))
    on = pred[:, 1, :].numpy()
    assert (on[:, :int(0.33 * 400)].min(1) == 0).all() and on[:, 200].all()


@pytest.mark.parametrize("shuffle", [False, True])
def test_mix_matches_jax(shuffle):
    x, x_wm = _audio(3, 400, seed=12), _audio(3, 400, seed=13)
    state = pyrandom.getstate()
    pyrandom.seed(3)
    start = pyrandom.randint(0, 200)
    np.random.seed(4)
    perm = np.random.permutation(3)
    pyrandom.seed(3)
    np.random.seed(4)
    want = jwmod.mix(x, x_wm, window_size=0.5, shuffle=shuffle)
    pyrandom.setstate(state)
    got = pwmod.mix(torch.from_numpy(x), torch.from_numpy(x_wm), 0.5,
                    shuffle=shuffle, start_point=start, perm=perm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


class _Draws:
    """Stands for Python's `random` in the JAX module: `uniform` returns
    the given values in order."""

    def __init__(self, values):
        self.values = list(values)

    def uniform(self, a, b):
        return self.values.pop(0)


EFFECT_DRAWS = {"speed": [0.8], "echo": [0.01, 0.3], "smooth": [5.7]}
EFFECTS = ["speed", "updownresample", "echo", "random_noise", "pink_noise",
           "lowpass_filter", "highpass_filter", "bandpass_filter", "smooth",
           "boost_audio", "duck_audio", "shush", "identity"]


@pytest.mark.parametrize("name", EFFECTS)
def test_effect_matches_jax(name, monkeypatch):
    x = _audio(2, 800, seed=14, scale=0.3)
    mask = (np.random.RandomState(15).rand(2, 1, 800) > 0.5).astype(
        np.float32)
    kw, jkw = {}, {}
    if name in EFFECT_DRAWS:
        monkeypatch.setattr(jfx, "random", _Draws(EFFECT_DRAWS[name]))
        draws = list(EFFECT_DRAWS[name])
        monkeypatch.setattr(pfx, "uniform",
                            lambda a, b, generator=None: draws.pop(0))
    if name in ("random_noise", "pink_noise"):
        key = jax.random.PRNGKey(17)
        jkw["rng"] = key
        shape = (x.shape if name == "random_noise"
                 else (16, x.shape[-1] // 16 + 1))
        noise = torch.from_numpy(np.array(jax.random.normal(key, shape)))
        monkeypatch.setattr(pfx, "randn", lambda shape, generator, device,
                            dtype=torch.float32: noise.to(device, dtype))
    want = getattr(jfx.AudioEffects, name)(jnp.asarray(x),
                                           mask=jnp.asarray(mask), **jkw)
    if name in EFFECT_DRAWS:   # the same draws again for the port
        monkeypatch.setattr(pfx, "uniform", lambda a, b, generator=None,
                            d=list(EFFECT_DRAWS[name]): d.pop(0))
    got = getattr(pfx.AudioEffects, name)(torch.from_numpy(x),
                                          mask=torch.from_numpy(mask), **kw)
    tol = 1e-5 if "filter" in name or "resample" in name or name == "speed" \
        else 1e-6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)
    if name == "speed":
        assert got[0].shape[-1] == 1000


def test_compress_with_encodec_matches_jax():
    codec = builders.get_debug_compression_model(device="cpu", seed=0)
    jmodel, jvars = _jax_codec(codec)
    x = _audio(2, 1600, seed=18, scale=0.3)
    want = np.asarray(jfx.compress_with_encodec(jnp.asarray(x), 2, jmodel,
                                                jvars, SR))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pfx.compress_with_encodec(xt, 2, codec, SR)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    got.sum().backward()   # straight through: the identity's gradient
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_select_audio_effects_matches_jax(monkeypatch):
    effects = {k: getattr(pfx.AudioEffects, k) for k in EFFECTS}
    weights = {k: 0.5 for k in EFFECTS}
    rng = pyrandom.Random(21)
    monkeypatch.setattr(jfx, "random", rng)
    for _ in range(5):
        state = rng.getstate()
        want = jfx.select_audio_effects(effects, weights, "weighted", 1)
        mirror = pyrandom.Random()
        mirror.setstate(state)
        monkeypatch.setattr(pfx, "uniform",
                            lambda a, b, generator=None: mirror.random())
        monkeypatch.setattr(pfx, "sample",
                            lambda keys, k, generator=None: mirror.sample(
                                keys, k))
        got = pfx.select_audio_effects(effects, weights, "weighted", 1)
        assert list(got) == list(want)
    monkeypatch.undo()
    got = pfx.select_audio_effects(effects, {k: 0.0 for k in effects},
                                   "weighted", 1)
    assert list(got) == ["identity"]
    assert len(pfx.select_audio_effects(effects, mode="all")) == len(effects)


# ------------------------------------------------------------------ solver
def _keep_grads(inner):
    """optax `inner`, its state also holding the last gradients."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)
    return optax.GradientTransformation(init, update)


def _jax_params(port):
    conv = dict(ratios=(8, 4), n_residual_layers=1, lstm=2)
    gen = {k: v.numpy() for k, v in port.generator.state_dict().items()}
    det = {k: v.numpy() for k, v in port.detector.state_dict().items()}
    return {"generator": torch_port.convert_audioseal_generator(gen, **conv),
            "detector": torch_port.convert_audioseal_detector(det, **conv)}


def _port_grads(port_like, tree):
    """A JAX {'generator', 'detector'} tree (gradients or parameters) on
    the port's names, through the linear weight map of `load_audioseal`."""
    from audiocraft_tpu_torch.utils import jax_weights
    jax_weights.load_audioseal(port_like, tree)
    return {**{f"generator.{k}": v.clone() for k, v in
               port_like.generator.state_dict().items()},
            **{f"detector.{k}": v.clone() for k, v in
               port_like.detector.state_dict().items()}}


def _named(solver, what):
    out = {}
    for prefix, model in (("generator", solver.generator),
                          ("detector", solver.detector)):
        for name, p in model.named_parameters():
            out[f"{prefix}.{name}"] = (p.grad if what == "grad" else p
                                       ).detach().clone()
    return out


@pytest.fixture(scope="module")
def solvers():
    port = get_solver(CFG, device="cpu")
    params = _jax_params(port)
    original = jwm.AudioSeal.init
    jwm.AudioSeal.init = lambda self, rng, example: params
    try:
        jsolver = jsolver_mod.WatermarkSolver(CFG)
    finally:
        jwm.AudioSeal.init = original
    jsolver.optimizer = _keep_grads(optax.adam(5e-5))
    jsolver.state = jsolver.state.replace(
        opt_state=jsolver.optimizer.init(jsolver.state.params))
    return port, jsolver


def test_two_steps_match_jax(solvers, monkeypatch):
    port, jsolver = solvers
    holder = get_solver(CFG, device="cpu")   # maps JAX trees to port names
    key = pyrandom.Random(31).getrandbits(31)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(key), (2, 1, T))))
    monkeypatch.setattr(jfx, "random", pyrandom.Random(31))
    monkeypatch.setattr(pfx, "randn", lambda shape, generator, device,
                        dtype=torch.float32: noise.to(device, dtype))
    np.random.seed(32)
    _, true_pred = jwmod.pad(_audio(2, T), central=False)
    masks = [true_pred[:, 1:2].astype(np.float32),
             np.ones((2, 1, T), np.float32)]
    step = jsolver._get_step("random_noise")
    for i, mask in enumerate(masks):
        x = _audio(2, T, seed=40 + i, scale=0.2)
        message = np.random.RandomState(50 + i).randint(0, 2, (2, 4))
        mask2 = np.concatenate([1 - mask, mask], axis=1)
        state_before = _np(jsolver.state)
        jsolver.state, jm = step(jax.tree.map(jnp.asarray, state_before),
                                 jnp.asarray(x), jnp.asarray(message, jnp.int32),
                                 jnp.asarray(mask2), jax.random.PRNGKey(0))
        if i == 1:  # the port starts step 2 from the JAX state after step 1
            _port_grads(port, state_before.params)
            port.optimizer.state.clear()
            opt = state_before.opt_state[1][0]
            named = _named(port, "param")
            mu, nu = (_port_grads(holder, t) for t in (opt.mu, opt.nu))
            for p, name in zip(
                    [p for m in (port.generator, port.detector)
                     for p in m.parameters()], named):
                port.optimizer.state[p] = {"step": torch.tensor(1.0),
                                           "exp_avg": mu[name],
                                           "exp_avg_sq": nu[name]}
            port.balancer.load_state_dict({
                "avg": {k: torch.tensor(float(v)) for k, v in
                        state_before.balancer_state.avg.items()},
                "count": torch.tensor(float(
                    state_before.balancer_state.count))})
        pm = port.train_step(torch.from_numpy(x), torch.from_numpy(message),
                             torch.from_numpy(mask), "random_noise")
        jm = _np(jm)
        assert set(pm) == set(jm)
        for k in jm:
            _close(float(pm[k]), jm[k], 1e-4)
        jgrads = _port_grads(holder, _np(jsolver.state.opt_state[0]))
        pgrads = _named(port, "grad")
        floor = 1e-6 * max(float(g.norm()) for g in jgrads.values())
        for name, g in pgrads.items():
            err = float((g - jgrads[name]).norm())
            assert err <= 2e-3 * float(jgrads[name].norm()) + floor, name
        jparams = _port_grads(holder, _np(jsolver.state.params))
        for name, p in _named(port, "param").items():
            assert float((p - jparams[name]).abs().max()) <= 2 * 5e-5, name
        jbal = _np(jsolver.state.balancer_state)
        for k, v in port.balancer.avg.items():
            _close(float(v), jbal.avg[k], 1e-4)


def test_speed_attack_raises_in_both(solvers, monkeypatch):
    port, jsolver = solvers
    monkeypatch.setattr(jfx, "random", _Draws([0.8]))
    monkeypatch.setattr(pfx, "uniform", lambda a, b, generator=None: 0.8)
    fx = {"speed": jfx.AudioEffects.speed}
    monkeypatch.setattr(jsolver, "augmentations", fx)
    monkeypatch.setattr(jsolver, "_steps_cache", {})
    monkeypatch.setattr(port, "augmentations",
                        {"speed": pfx.AudioEffects.speed})
    x, mask = _audio(2, T), np.ones((2, 1, T), np.float32)
    with pytest.raises((TypeError, ValueError)):
        jsolver._get_step("speed")(
            jax.tree.map(jnp.copy, jsolver.state), jnp.asarray(x),
            jnp.zeros((2, 4), jnp.int32),
            jnp.asarray(np.concatenate([1 - mask, mask], 1)),
            jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="changed the length"):
        port.train_step(torch.from_numpy(x), torch.zeros(2, 4, dtype=torch.long),
                        torch.from_numpy(mask), "speed")


def test_run_step_and_evaluate(solvers):
    port, jsolver = solvers
    metrics = port.run_step(0, _audio(2, T, seed=60), {})
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert {"d_loss", "mb_loss", "percep_loss", "l1", "msspec",
            "tf_loudnessratio"} <= set(metrics)
    # evaluate on the same weights and message as the JAX solver
    jparams = _jax_params(port)
    jsolver.state = jsolver.state.replace(params=jax.tree.map(jnp.asarray,
                                                               jparams))
    batches = [_audio(2, 640, seed=61, scale=0.2)]
    port.dataloaders["evaluate"] = batches
    jsolver.dataloaders = {"evaluate": batches}
    jsolver._np_rng = np.random.RandomState(62)
    message = torch.from_numpy(np.random.RandomState(62).randint(0, 2, (2, 4)))
    original = psolver_mod.random_message
    psolver_mod.random_message = lambda g, nbits, B: message
    try:
        got = port.evaluate()
    finally:
        psolver_mod.random_message = original
    want = jsolver.evaluate()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


def test_registry_and_config_faults():
    cfg = load_config("solver/watermark/default")
    assert cfg["dataset"]["segment_duration"] is None
    with pytest.raises(TypeError):
        get_solver(cfg, device="cpu")
    with pytest.raises(TypeError):
        jsolver_mod.WatermarkSolver(cfg)
    cfg["dataset"]["segment_duration"] = 1.0
    solver = get_solver(cfg, device="cpu")
    assert isinstance(solver, psolver_mod.WatermarkSolver)
    assert solver.segment_samples == 16000 and solver.nbits == 16
    assert set(solver.balancer.weights) == {"l1", "msspec", "tf_loudnessratio"}
    robust = load_config("solver/watermark/robustness")
    robust["dataset"]["segment_duration"] = 1.0
    from audiocraft_tpu_torch.data import _native
    if _native.av_available():
        assert len(get_solver(robust, device="cpu").augmentations) == 14
    else:  # the mp3 and aac attacks need libav
        with pytest.raises(RuntimeError, match="libav"):
            get_solver(robust, device="cpu")
    for name in pfx.CODEC_EFFECTS:
        robust["aug_weights"][name] = 0.0
    solver = get_solver(robust, device="cpu")
    assert len(solver.augmentations) == 14
