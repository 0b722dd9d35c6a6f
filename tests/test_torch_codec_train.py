"""EnCodec training of the port (`quantization/core_vq.py`'s k-means,
`models/encodec.py`'s training forward and renormalisation,
`solvers/compression.py`) against the JAX package on the CPU, at
`tests/models/test_compression_step.py`'s widths (SEANet 4 filters,
dimension 32, ratios 10-8-8 at 16 kHz; MS-STFT at 2 filters over 128 and 64
bins), with weight norm, one LSTM layer and 4 k-means codebooks of 8 codes:

- `kmeans`, and the EMA update of a codebook that is not `inited`, from the
  same initial means; the RVQ's first training step from
  codebooks that are not `inited` (k-means, the zero codebook's codes and
  commitment, dead codes), the JAX package's draws injected;
- `EncodecModel.forward` in training mode, plain, with `renormalize` and
  with the `no_quant` quantizer, and encode / decode with the scale;
- two full steps of `CompressionSolver` against `make_compression_train_step`
  (the JAX step compiled once for the module) on the same weights and
  draws: every metric, every generator gradient (after clipping), the
  generator and discriminator parameters, the balancer's state and the
  codebooks after k-means and after the EMA step;
- the valid step and `evaluate` against JAX's on the JAX state;
- the registry; a checkpoint resumed bit for bit; the trained codec read
  back as a package, a `compression_model_checkpoint` and from a JAX
  training state.

Tolerances: k-means means atol 1e-6 and sizes equal; codebooks atol 2e-5
(the EMA of latents from f32 convolutions), sizes atol 1e-6, codes equal;
forwards atol 1e-5 / rtol 1e-4; losses and metrics rtol 2e-4 (deep f32
stacks, STFTs and log-spectra); each gradient's L2 error within 2e-3 of its
L2 norm; a parameter after each Adam step within 2 x lr of JAX's (one
step moves a weight by about lr x sign(g), which f32 rounding of a
near-zero g may flip); the balancer's state rtol 1e-4; the step-2
comparisons start from the JAX state after step 1, carried into the port,
with each side's own Adam moments; the valid step rtol 2e-4; `evaluate`
rtol 1e-3 (SI-SNR in dB of a reconstruction that is mostly error); the
resumed step equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu import quantization as jq
from audiocraft_tpu.losses import Balancer as JaxBalancer
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.solvers import compression as jcomp
from audiocraft_tpu.utils import checkpoint as jckpt
from audiocraft_tpu_torch import quantization as tq
from audiocraft_tpu_torch.config import load_config
from audiocraft_tpu_torch.models import builders, loaders
from audiocraft_tpu_torch.models.encodec import InterleaveStereoCompressionModel
from audiocraft_tpu_torch.quantization import core_vq
from audiocraft_tpu_torch.solvers import get_solver
from audiocraft_tpu_torch.solvers.compression import CompressionSolver
from audiocraft_tpu_torch.solvers.musicgen import MusicGenSolver
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

SR = 16000
T = 3200          # 5 frames of 640 samples a row: 10 latents, 8 codes
BINS = 8
LR = 3e-4


def _codec_cfg(renormalize=False, quantizer="rvq", kmeans_init=True,
               threshold=2.0):
    return {"compression_model": "encodec", "encodec": {
        "autoencoder": "seanet", "quantizer": quantizer, "sample_rate": SR,
        "channels": 1, "renormalize": renormalize,
        "seanet": {"dimension": 32, "n_filters": 4, "n_residual_layers": 1,
                   "ratios": [10, 8, 8], "lstm": 1, "norm": "weight_norm"},
        "rvq": {"n_q": 4, "bins": BINS, "decay": 0.99,
                "kmeans_init": kmeans_init,
                "threshold_ema_dead_code": threshold}}}


CFG = {"solver": "compression", "seed": 0, "sample_rate": SR, "channels": 1,
       **_codec_cfg(),
       "losses": {"adv": 4.0, "feat": 4.0, "l1": 0.1, "msspec": 2.0,
                  "mel": 0.0, "sisnr": 0.0},
       "balancer": {"monitor": True},
       "adversarial": {"adversaries": ["msstftd"], "adv_loss": "hinge",
                       "feat_loss": "l1", "every": 1},
       "msstftd": {"filters": 2, "n_ffts": [128, 64], "hop_lengths": [32, 16],
                   "win_lengths": [128, 64]},
       "mel": {"n_fft": 256, "hop_length": 64, "win_length": 256, "n_mels": 16},
       "msspec": {"range_start": 6, "range_end": 8, "n_mels": 8,
                  "normalized": True, "alphas": False},
       "sisnr": {"segment": 0.05}, "mrstft": {},
       "optim": {"lr": LR, "max_norm": 1.0}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(seed, shape=(2, 1, T)):
    return (np.random.RandomState(seed).randn(*shape) * 0.2).astype(np.float32)


def _init(model, seed):
    """The JAX codec's variables, its init jitted (eager flax init is
    slow)."""
    return jax.jit(lambda r: model.init(r, segment_length=T))(
        jax.random.PRNGKey(seed))


def _draws(rng, n, bins, n_q):
    """The indices the JAX RVQ draws inside a training step keyed by rng,
    per level (k-means' initial means, then the dead codes')."""
    rng_q, _ = jax.random.split(rng)
    out = []
    for lrng in jax.random.split(rng_q, n_q):
        pair = []
        for r in jax.random.split(lrng):
            pair.append(np.asarray(
                jax.random.permutation(r, n)[:bins] if n >= bins
                else jax.random.randint(r, (bins,), 0, n)))
        out.append(pair)
    return out


def _inject(monkeypatch, draws, init: bool):
    """Replace the port's `sample_vectors` by the JAX draws, in the port's
    call order (per level: k-means when not `inited`, then expiry)."""
    queue = [d for level in draws for d in (level if init else level[1:])]

    def sample_vectors(samples, num, generator=None):
        idx = torch.from_numpy(queue.pop(0).astype(np.int64))
        assert len(idx) == num
        return samples[idx]

    monkeypatch.setattr(core_vq, "sample_vectors", sample_vectors)
    return queue


def _codebooks(quantizer) -> dict:
    return {f"{i}.{name}": getattr(layer._codebook, name).numpy().copy()
            for i, layer in enumerate(quantizer.vq.layers)
            for name in ("inited", "cluster_size", "embed", "embed_avg")}


def _jax_codebooks(state) -> dict:
    books = state.codebooks
    return {f"{i}.{name}": np.asarray(getattr(books, name)[i], np.float32
                                      ).reshape(getattr(books, name)[i].shape
                                                or (1,))
            for i in range(books.embed.shape[0])
            for name in ("inited", "cluster_size", "embed", "embed_avg")}


def _assert_codebooks(got: dict, want: dict):
    for key, value in want.items():
        tol = 2e-5 if "embed" in key else 1e-6
        np.testing.assert_allclose(got[key], value, rtol=0, atol=tol,
                                   err_msg=key)


# ------------------------------------------------------------- quantizer
def test_kmeans_matches_jax():
    samples = _audio(0, (40, 6))
    rng = jax.random.PRNGKey(3)
    want_means, want_bins = jq.kmeans(rng, jnp.asarray(samples), 5)
    idx = np.asarray(jax.random.permutation(rng, 40)[:5])
    means, bins = core_vq.kmeans(torch.from_numpy(samples), 5,
                                 means=torch.from_numpy(samples[idx]))
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))
    assert int(bins.sum()) == 40

    # the update of a codebook that is not `inited`, its k-means started
    # from injected means (no dead codes: threshold 0)
    state = jq.init_codebook(jax.random.PRNGKey(0), 5, 6, kmeans_init=True)
    rng_init, _ = jax.random.split(rng)
    want = jq.ema_codebook_update(state, jnp.asarray(samples), None, rng,
                                  decay=0.9, epsilon=1e-5,
                                  threshold_ema_dead_code=0.0)
    book = core_vq.EuclideanCodebook(6, 5, kmeans_init=True)
    idx = np.asarray(jax.random.permutation(rng_init, 40)[:5])
    core_vq.ema_codebook_update(book, torch.from_numpy(samples), decay=0.9,
                                epsilon=1e-5, threshold_ema_dead_code=0.0,
                                init_means=torch.from_numpy(samples[idx]))
    assert bool(book.inited) and int(book.last_expired) == 0
    for name in ("cluster_size", "embed", "embed_avg"):
        np.testing.assert_allclose(getattr(book, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("n_latents", [24, 6])  # >= and < the 8 codes
def test_first_training_step_runs_kmeans_as_jax(monkeypatch, n_latents):
    """From zero codebooks that are not `inited`: every level quantizes
    against zeros (codes 0, commitment = mean square of its residual),
    then takes k-means of its batch, its dead codes and its EMA step."""
    x = _audio(1, (2, n_latents // 2, 16))
    state = jq.init_rvq(jax.random.PRNGKey(0), 3, BINS, 16, kmeans_init=True)
    rng = jax.random.PRNGKey(5)
    want_q, want_codes, want_commits, new_state = jax.jit(
        lambda s, a, r: jq.rvq_forward(s, a, n_q_active=jnp.asarray(3),
                                       training=True, rng=r))(
        state, jnp.asarray(x), rng)
    rvq = tq.ResidualVectorQuantizer(16, 3, BINS, kmeans_init=True).train()
    assert not any(bool(layer._codebook.inited) for layer in rvq.vq.layers)
    # the JAX draws: rvq_forward splits its key per level itself
    draws = []
    for lrng in jax.random.split(rng, 3):
        draws.append([np.asarray(
            jax.random.permutation(r, n_latents)[:BINS] if n_latents >= BINS
            else jax.random.randint(r, (BINS,), 0, n_latents))
            for r in jax.random.split(lrng)])
    queue = _inject(monkeypatch, draws, init=True)
    res = rvq(torch.from_numpy(x.transpose(0, 2, 1)), frame_rate=25)
    assert not queue
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(want_codes))
    assert not res.codes.any()
    np.testing.assert_allclose(res.x.numpy().transpose(0, 2, 1),
                               np.asarray(want_q), atol=1e-6)
    np.testing.assert_allclose(res.penalty.item(),
                               float(jnp.sum(want_commits)) / 3, rtol=1e-6)
    _assert_codebooks(_codebooks(rvq), _jax_codebooks(new_state))
    assert all(bool(layer._codebook.inited) for layer in rvq.vq.layers)


# ------------------------------------------------------------------ model
def _models(variant):
    cfg = _codec_cfg(renormalize=variant == "renormalize",
                     quantizer="no_quant" if variant == "no_quant" else "rvq",
                     kmeans_init=False, threshold=0.0)
    jmodel = jbuilders.get_compression_model(cfg)
    variables = _init(jmodel, 2)
    port = builders.get_compression_model(cfg, device="cpu")
    tree = _np(variables)
    if variant == "no_quant":
        out: dict = {}
        jax_weights._seanet(tree["params"]["encoder"], port.encoder.model,
                            "encoder.", False, out)
        jax_weights._seanet(tree["params"]["decoder"], port.decoder.model,
                            "decoder.", True, out)
        jax_weights._load(port, out)
    else:
        jax_weights.load_encodec(port, tree)
    return jmodel, variables, port


@pytest.mark.parametrize("variant", ["plain", "renormalize", "no_quant"])
def test_encodec_forward_matches_jax(variant):
    jmodel, variables, port = _models(variant)
    x = _audio(2) * np.array([1.0, 0.05], np.float32)[:, None, None]
    want, new_vars = jax.jit(lambda v, a: jmodel.forward(
        v, a, training=True, rng=jax.random.PRNGKey(0)))(variables,
                                                         jnp.asarray(x))
    res = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(res.x.detach().numpy(), np.asarray(want.x),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(res.bandwidth.item(),
                               float(np.mean(want.bandwidth)), rtol=1e-6)
    if variant == "no_quant":
        assert res.penalty is None and want.penalty is None
        return
    np.testing.assert_allclose(res.penalty.item(), float(want.penalty),
                               rtol=1e-4)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(want.codes))
    _assert_codebooks(_codebooks(port.quantizer),
                      _jax_codebooks(new_vars["quantizer"]))
    # inference: encode returns the scale, decode applies it
    codes, scale = port.eval().encode(torch.from_numpy(x), device="cpu")
    jcodes, jscale = jmodel.encode(new_vars, jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert (scale is None) == (jscale is None) == (variant == "plain")
    if scale is not None:
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                                   rtol=1e-5)
    np.testing.assert_allclose(
        port.decode(codes, scale, device="cpu").numpy(),
        np.asarray(jmodel.decode(new_vars, jcodes, jscale)), atol=1e-5,
        rtol=1e-4)


def test_interleaved_stereo_forward_raises():
    stereo = InterleaveStereoCompressionModel(
        builders.get_debug_compression_model(device="cpu"))
    with pytest.raises(NotImplementedError, match="encode and decode"):
        stereo(torch.zeros(1, 2, 3200))


# ------------------------------------------------------------------ steps
def _keep_grads(inner):
    """optax `inner`, its state also holding the last gradients."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)
    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step, compiled once: two steps from the JAX init on two
    batches, keeping the state before each step and its gradients."""
    model = jbuilders.get_compression_model(CFG)
    variables = _init(model, 0)
    aux = jcomp.get_aux_losses(CFG, SR)
    advs = jcomp.get_adversarial_losses(CFG, SR)
    balancer = JaxBalancer({}, monitor=True)
    optimizer = _keep_grads(optax.adam(LR, b1=0.5, b2=0.9))
    step = jcomp.make_compression_train_step(
        model, advs, aux, CFG["losses"], balancer, optimizer, disc_every=1,
        max_norm=1.0)
    batches = [_audio(10), _audio(11)]
    state = jcomp.CompressionTrainState(
        step=jnp.zeros((), jnp.int32), gen_vars=variables,
        gen_opt_state=optimizer.init(variables["params"]),
        adv_states={n: jax.jit(a.init)(jax.random.PRNGKey(1),
                                       jnp.asarray(batches[0]))
                    for n, a in advs.items()},
        balancer_state=balancer.init_state())
    states, metrics, rngs = [_np(state)], [], []
    for i, x in enumerate(batches):
        rngs.append(jax.random.PRNGKey(20 + i))
        state, m = step(state, jnp.asarray(x), rngs[-1])
        states.append(_np(state))
        metrics.append(_np(m))
    valid = jcomp.make_compression_valid_step(model, aux, advs)
    valid_metrics = _np(valid(state.gen_vars, state.adv_states,
                              jnp.asarray(batches[1])))
    return dict(model=model, batches=batches, states=states, rngs=rngs,
                metrics=metrics, valid=valid_metrics)


def _tree(state) -> dict:
    return {"gen_vars": state.gen_vars,
            "adv_states": {n: {"params": s.params}
                           for n, s in state.adv_states.items()}}


def _gen_names(model, params) -> dict:
    out: dict = {}
    jax_weights._seanet(params["encoder"], model.encoder.model, "encoder.",
                        False, out)
    jax_weights._seanet(params["decoder"], model.decoder.model, "decoder.",
                        True, out)
    return out


def test_two_compression_steps_match_jax(monkeypatch, jax_run):
    solver = get_solver(CFG, device="cpu")
    assert isinstance(solver, CompressionSolver)
    states = jax_run["states"]
    solver.load_jax_params(_tree(states[0]))
    for i, x in enumerate(jax_run["batches"]):
        if i:  # each step starts from the JAX state (the Adam moments kept)
            solver.load_jax_params(_tree(states[i]))
        inited = bool(solver.model.quantizer.vq.layers[0]._codebook.inited)
        queue = _inject(monkeypatch, _draws(jax_run["rngs"][i], 10, BINS, 4),
                        init=not inited)
        got = solver.run_step(i, x, {})
        assert not queue
        want = jax_run["metrics"][i]
        assert set(got) == set(want), (set(got) ^ set(want))
        for key, value in want.items():
            np.testing.assert_allclose(float(got[key]), float(value),
                                       rtol=2e-4, atol=1e-7, err_msg=key)
        after = states[i + 1]
        # gradients (after clipping), then the updated weights
        grads = _gen_names(solver.model, after.gen_opt_state[0])
        for name, p in solver.model.named_parameters():
            want_g = grads[name]
            err = np.linalg.norm(p.grad.numpy() - want_g)
            assert err <= 2e-3 * np.linalg.norm(want_g), (i, name, err)
        weights = _gen_names(solver.model, after.gen_vars["params"])
        for name, p in solver.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), weights[name],
                                       rtol=0, atol=2 * LR, err_msg=name)
        disc = solver.adv_losses["msstftd"].adversary
        want_d = jax_weights.adversary_state(
            disc, after.adv_states["msstftd"].params)
        for name, value in disc.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want_d[name], rtol=0,
                                       atol=2 * LR, err_msg=name)
        _assert_codebooks(_codebooks(solver.model.quantizer),
                          _jax_codebooks(after.gen_vars["quantizer"]))
        np.testing.assert_allclose(solver.balancer.count.item(),
                                   float(after.balancer_state.count),
                                   rtol=1e-6)
        for name, value in after.balancer_state.avg.items():
            np.testing.assert_allclose(solver.balancer.avg[name].item(),
                                       float(value), rtol=1e-4, err_msg=name)
    assert solver.step == 2


def test_valid_step_and_evaluate_match_jax(jax_run, tmp_path):
    final = jax_run["states"][-1]
    solver = get_solver(CFG, device="cpu")
    solver.load_jax_params(_tree(final))
    before = copy.deepcopy(solver.model.state_dict())
    solver.current_stage = "valid"
    got = solver.run_step(0, jax_run["batches"][1], {})
    want = jax_run["valid"]
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=2e-4,
                                   err_msg=key)
    for key, value in solver.model.state_dict().items():  # no update
        assert torch.equal(value, before[key]), key
    assert solver.model.training

    # evaluate: SI-SNR and RVM of the reconstruction, the JAX solver's way
    jsolver = object.__new__(jcomp.CompressionSolver)
    jsolver.cfg, jsolver.model = CFG, jax_run["model"]
    jsolver.state = final
    loader = [_audio(30), (_audio(31), None)]
    jsolver.dataloaders = solver.dataloaders = {"evaluate": loader}
    want = jsolver.evaluate()
    got = solver.evaluate()
    assert set(got) == set(want) == {"sisnr", "rvm", "rvm_0", "rvm_1",
                                     "rvm_2", "rvm_3"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, err_msg=key)
    # the generate stage stores one batch of reconstructions
    solver.cfg["folder"] = str(tmp_path)
    assert solver.generate() == {"generated_samples": 2}
    assert len(list((tmp_path / "samples" / "1").glob("*.wav"))) == 2


def test_compression_solver_from_the_registry():
    """`solver/compression/debug` (no adversary, no balancing) builds the
    port's solver with k-means codebooks and takes a step; without an
    `encodec` group the debug codec."""
    cfg = load_config("solver/compression/debug")
    solver = get_solver(cfg, device="cpu")
    assert type(solver) is CompressionSolver and not solver.adv_losses
    quantizer = solver.model.quantizer
    assert quantizer.total_codebooks == 2 and quantizer.bins == 48
    assert not any(bool(layer._codebook.inited)
                   for layer in quantizer.vq.layers)
    metrics = solver.run_step(0, _audio(3, (2, 1, SR)), {})
    assert np.isfinite(float(metrics["g_loss"]))
    assert all(bool(layer._codebook.inited) for layer in quantizer.vq.layers)
    assert solver.generate() == {}
    debug = get_solver({"solver": "compression", "sample_rate": SR},
                       device="cpu")
    assert debug.model.frame_rate == 25 and debug.model.quantizer.bins == 400


def test_checkpoint_resumes_bitwise_and_loads_as_a_codec(tmp_path):
    cfg = dict(CFG, folder=str(tmp_path / "xp"))
    batches = [_audio(40), _audio(41)]
    first = get_solver(cfg, device="cpu")
    first.run_step(0, batches[0], {})
    first.save_checkpoints()
    want = first.run_step(1, batches[1], {})
    resumed = get_solver(cfg, device="cpu")
    assert resumed.restore()
    got = resumed.run_step(1, batches[1], {})
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    for a, b in ((first.model, resumed.model),
                 (first.adv_losses["msstftd"].adversary,
                  resumed.adv_losses["msstftd"].adversary)):
        for (key, value), other in zip(a.state_dict().items(),
                                       b.state_dict().values()):
            assert torch.equal(value, other), key
    assert resumed.step == first.step == 2
    for key, value in first.balancer.avg.items():
        assert torch.equal(resumed.balancer.avg[key], value)

    # the checkpoint of step 1 as a codec: a package, a solver's frozen
    # codec, and `model_from_checkpoint`
    saved = torch.load(tmp_path / "xp" / "checkpoint.th", weights_only=True)
    codecs = [loaders.load_compression_model(str(tmp_path / "xp"),
                                             device="cpu"),
              CompressionSolver.model_from_checkpoint(
                  tmp_path / "xp" / "checkpoint.th", device="cpu")]
    lm_cfg = load_config("solver/musicgen/debug")
    lm_cfg["compression_model_checkpoint"] = str(tmp_path / "xp")
    codecs.append(MusicGenSolver(lm_cfg, device="cpu").compression_model)
    x = torch.from_numpy(_audio(42))
    for codec in codecs:
        state = codec.state_dict()
        assert set(state) == set(saved["model"])
        for key, value in saved["model"].items():
            assert torch.equal(state[key], value), key
        codes, scale = codec.encode(x, device="cpu")
        assert scale is None and codes.shape == (2, 4, 5)
    assert all(bool(v) for k, v in saved["model"].items()
               if k.endswith("inited"))


def test_warm_start_from_a_jax_training_state(tmp_path, jax_run):
    final = jax_run["states"][-1]
    path = tmp_path / "jax" / "checkpoint.th"
    path.parent.mkdir()
    jckpt.save_checkpoint(final, path)
    cfg = dict(CFG, folder=str(tmp_path / "xp"), continue_from=str(path))
    solver = get_solver(cfg, device="cpu")
    assert solver.restore(cfg["continue_from"]) and solver.epoch == 0
    weights = _gen_names(solver.model, final.gen_vars["params"])
    for name, p in solver.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), weights[name])
    _assert_codebooks(_codebooks(solver.model.quantizer),
                      _jax_codebooks(final.gen_vars["quantizer"]))
    disc = solver.adv_losses["msstftd"].adversary
    want = jax_weights.adversary_state(disc, final.adv_states["msstftd"].params)
    for name, value in disc.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name])
