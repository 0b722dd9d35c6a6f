"""Multi-Band Diffusion training of the port (`solvers/diffusion.py`, the
training half of `modules/diffusion_schedule.py`) against the JAX package on
the CPU, at a small U-Net (hidden 8, depth 2, BiLSTM, codec condition) over
the debug codec:

- `MultiBandProcessor.update` over four batches that cross `num_samples`,
  and `NoiseSchedule.get_training_item` (a step per row, and one step), each
  with the JAX package's draws injected; both packages take channels-first
  [B, C, T] batches here, as the JAX solver's step hands them over;
- the solver's condition (the codec's latents of its own codes) and one
  `run_step` against the JAX solver's jitted step on the same U-Net weights
  (the JAX init carried by `jax_weights.load_diffusion_unet`) and the same
  draws: the loss, the per-stage losses, every gradient and the Adam update;
- `PerStageMetrics` and `DataProcess` (boost, band filter, resampling);
- a run stopped after one step and resumed from its checkpoint takes the
  same second step as one that was not stopped, bit for bit; a JAX
  training state warm-starts the U-Net.

Tolerances: processor statistics rtol 1e-5 (f32 FIR filters summed in
another order); training items atol 1e-5; the condition atol 1e-5; the
loss rtol 1e-5 and each gradient within 1e-4 of its largest entry (f32
convolutions and LSTM steps; sums in another order); the Adam update atol
1e-6 where a gradient is above 1e-3 of its largest entry (elsewhere lr
times g / (|g| + eps) may round either way; both stay within lr, plus the
f32 rounding of the weight); the
metrics and data processing atol 1e-6; the resumed step equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu.models import unet as junet
from audiocraft_tpu.modules import diffusion_schedule as jsched
from audiocraft_tpu.solvers import diffusion as jdiff
from audiocraft_tpu.utils import checkpoint as jckpt
from audiocraft_tpu_torch.modules import diffusion_schedule as tsched
from audiocraft_tpu_torch.solvers import diffusion as tdiff
from audiocraft_tpu_torch.solvers import get_solver
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import (SCHEDULE, _jax_codec, _one_torch_thread,  # noqa: F401
                                   _seeded)

UNET = dict(hidden=8, depth=2, growth=2.0, kernel=4, stride=2, norm_groups=4,
            bilstm=True, emb_all_layers=True, codec_dim=32)
CFG = {"solver": "diffusion", "seed": 1, "sample_rate": 32000, "channels": 1,
       "schedule": SCHEDULE, "diffusion_unet": UNET,
       "processor": {"name": "multi_band_processor", "use": True,
                     "n_bands": 8, "num_samples": 10000},
       "optim": {"lr": 2e-4}}
T = 5120   # 4 frames of the debug codec


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _item_draws(rng, shape, num_steps, tensor_step=True):
    """The JAX `get_training_item`'s steps and noise from its key."""
    rng_step, rng_noise = jax.random.split(rng)
    step = jax.random.randint(rng_step, (shape[0],) if tensor_step else (), 0,
                              num_steps)
    return np.asarray(step), np.asarray(jax.random.normal(rng_noise, shape))


def test_band_processor_update_matches_jax_across_num_samples():
    """B 2 and num_samples 5: the counts go 2, 4, 6, then stay at 6."""
    jproc = jsched.MultiBandProcessor(8, 32000, num_samples=5)
    port = tsched.MultiBandProcessor(8, 32000, num_samples=5)
    state = jproc.init_state()
    for i in range(4):
        x = _seeded((2, 1, 3000), seed=i, scale=0.2)
        rng = jax.random.PRNGKey(i)
        state = jproc.update(state, jnp.asarray(x), rng)
        noise = np.array(jax.random.normal(rng, x.shape))
        port.update(torch.from_numpy(x), noise=torch.from_numpy(noise))
        assert float(port.counts) == float(state.counts) == min(2 * i + 2, 6)
        for name in ("sum_x", "sum_x2", "sum_target_x2"):
            np.testing.assert_allclose(getattr(port, name).numpy(),
                                       np.asarray(getattr(state, name)),
                                       rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("tensor_step", [True, False])
def test_training_item_matches_jax(tensor_step):
    jproc = jsched.MultiBandProcessor(8, 32000)
    state = jproc.update(jproc.init_state(), jnp.asarray(
        _seeded((3, 1, 2000), seed=7, scale=0.3)), jax.random.PRNGKey(7))
    port = tsched.MultiBandProcessor(8, 32000)
    jax_weights.load_band_processor(port, state)
    ours = tsched.NoiseSchedule(sample_processor=port, **SCHEDULE)
    theirs = jsched.NoiseSchedule(sample_processor=jproc, **SCHEDULE)
    x = _seeded((3, 1, 2000), seed=8, scale=0.3)
    rng = jax.random.PRNGKey(9)
    want = theirs.get_training_item(rng, jnp.asarray(x), proc_state=state,
                                    tensor_step=tensor_step)
    step, noise = _item_draws(rng, x.shape, 1000, tensor_step)
    got = ours.get_training_item(torch.from_numpy(x), step=torch.from_numpy(
        step), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
    np.testing.assert_array_equal(got.noise.numpy(), np.asarray(want.noise))
    np.testing.assert_allclose(got.noisy.numpy(), np.asarray(want.noisy),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """The port's solver (CPU) with the JAX U-Net init's weights, and the JAX
    solver's jitted step over the same U-Net, schedule and processor (the
    JAX solver built without its constructor, which inits a codec), whose
    optimizer runs Adam and keeps the gradients in its state."""
    solver = get_solver(CFG, device="cpu")
    jmodel = junet.DiffusionUnet(chin=1, num_steps=1000,
                                 **{k: v for k, v in UNET.items()})
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, T, 1)), 0,
                         condition=jnp.zeros((1, 4, 32)))
    jax_weights.load_diffusion_unet(solver.model, _np(params))
    adam = optax.adam(2e-4)
    keep = optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), adam.init(p)),
        lambda g, s, p=None: (adam.update(g, s[1], p)[0],
                              (g, adam.update(g, s[1], p)[1])))
    jsolver = object.__new__(jdiff.DiffusionSolver)
    jsolver.model = jmodel
    jsolver.sample_processor = jsched.MultiBandProcessor(8, 32000)
    jsolver.schedule = jsched.NoiseSchedule(
        sample_processor=jsolver.sample_processor, **SCHEDULE)
    jsolver.optimizer = keep
    jsolver.data_processor = jdiff.DataProcess(initial_sr=32000)
    state = jdiff.DiffusionTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=keep.init(params),
        proc_state=jsolver.sample_processor.init_state())
    return solver, jsolver, state, params


def test_condition_matches_jax(pair):
    solver = pair[0]
    jcodec, jvars = _jax_codec(solver.codec)
    jsolver = object.__new__(jdiff.DiffusionSolver)
    jsolver.codec_model, jsolver.codec_variables = jcodec, jvars
    x = _seeded((2, 1, T), seed=3, scale=0.2)
    want = np.asarray(jsolver.get_condition(jnp.asarray(x)))
    got = solver.get_condition(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-5, rtol=0)


def test_run_step_matches_the_jax_step(pair, monkeypatch):
    solver, jsolver, state, params = pair
    x = _seeded((2, 1, T), seed=4, scale=0.2)
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    condition = solver.get_condition(torch.from_numpy(x))
    rng = jax.random.PRNGKey(11)
    rng_proc, rng_item = jax.random.split(rng)
    ref = np.asarray(jax.random.normal(rng_proc, x.shape))
    step, noise = _item_draws(rng_item, x.shape, 1000)
    loss_fn = tdiff.diffusion_loss
    monkeypatch.setattr(tdiff, "diffusion_loss", lambda *a, **kw: loss_fn(
        *a, **kw, ref_noise=torch.from_numpy(ref), step=torch.from_numpy(step),
        noise=torch.from_numpy(noise)))
    metrics = solver.run_step(0, (x,), {})
    new_state, jm = jsolver._make_step()(
        jax.tree.map(jnp.copy, state), jnp.asarray(x),
        jnp.asarray(condition.numpy().transpose(0, 2, 1)), rng)
    np.testing.assert_array_equal(np.asarray(jm["steps"]), step)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    per_stage = jdiff.PerStageMetrics(1000)(
        {"loss": np.asarray(jm["per_item"])}, np.asarray(jm["steps"]))
    assert set(per_stage) == set(metrics) - {"loss"}
    for key, value in per_stage.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-5)
    np.testing.assert_allclose(float(solver.sample_processor.counts),
                               float(new_state.proc_state.counts))
    np.testing.assert_allclose(solver.sample_processor.sum_x2.numpy(),
                               np.asarray(new_state.proc_state.sum_x2),
                               rtol=1e-5)
    grads = jax_weights.diffusion_unet_state(_np(new_state.opt_state[0]), 2)
    updated = jax_weights.diffusion_unet_state(_np(new_state.params), 2)
    for name, p in solver.model.named_parameters():
        want = grads[name]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=name)
        large = np.abs(want) > 1e-3 * scale
        delta = (p.detach() - before[name]).numpy()
        want_delta = updated[name] - before[name].numpy()
        np.testing.assert_allclose(delta[large], want_delta[large], atol=1e-6,
                                   rtol=0, err_msg=name)
        assert np.abs(delta).max() <= 2e-4 + 1e-6  # lr, and the f32 rounding


def test_warm_start_from_a_jax_checkpoint(pair, tmp_path):
    """The JAX solver's training state saved by the JAX package's
    `save_checkpoint`, given as `continue_from`: the U-Net's weights."""
    _, _, state, params = pair
    path = tmp_path / "jax" / "checkpoint.th"
    path.parent.mkdir()
    jckpt.save_checkpoint(state, path)
    fresh = get_solver(dict(CFG, folder=str(tmp_path / "xp")), device="cpu")
    assert fresh.restore(continue_from=str(path.parent)) and fresh.epoch == 0
    want = jax_weights.diffusion_unet_state(_np(params), 2)
    for key, value in fresh.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_per_stage_metrics_match_jax():
    rs = np.random.RandomState(0)
    steps, losses = rs.randint(0, 1000, 9), rs.rand(9).astype(np.float32)
    ours, theirs = tdiff.PerStageMetrics(1000, 4), jdiff.PerStageMetrics(1000, 4)
    want = theirs({"loss": losses}, steps)
    got = ours({"loss": torch.from_numpy(losses)}, torch.from_numpy(steps))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0)
    assert ours({"loss": 0.5}, 600) == theirs({"loss": 0.5}, 600) == {
        "loss_2": 0.5}


@pytest.mark.parametrize("kw", [
    dict(boost=True), dict(use_filter=True, idx_band=2),
    dict(use_resampling=True, target_sr=16000),
    dict(boost=True, use_filter=True, idx_band=1, use_resampling=True,
         target_sr=24000)], ids=["boost", "filter", "resample", "all"])
def test_data_process_matches_jax(kw):
    x = _seeded((2, 1, 4000), seed=5, scale=0.05)
    want = jdiff.DataProcess(initial_sr=32000, **kw)
    got = tdiff.DataProcess(initial_sr=32000, **kw)
    out = got.process_data(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want.process_data(
        jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got.inverse_process(out).numpy(),
        np.asarray(want.inverse_process(jnp.asarray(out.numpy()))),
        atol=1e-6, rtol=0)
    assert got.process_data(None) is None


def test_resume_takes_the_same_step(tmp_path):
    """Two steps in one run against one step, a checkpoint and a fresh
    solver's restore and step: weights, Adam's state, the processor's
    statistics and the generator equal bit for bit."""
    batches = [_seeded((2, 1, T), seed=s, scale=0.2) for s in (20, 21)]
    cfg = dict(CFG, folder=str(tmp_path / "xp"))
    whole = get_solver(cfg, device="cpu")
    for i, x in enumerate(batches):
        whole.run_step(i, x, {})
    first = get_solver(cfg, device="cpu")
    first.run_step(0, batches[0], {})
    first.save_checkpoints()
    resumed = get_solver(cfg, device="cpu")
    assert resumed.restore()
    resumed.run_step(1, batches[1], {})
    want, got = whole.state_dict(), resumed.state_dict()
    for part in ("model", "processor"):
        for key, value in want[part].items():
            assert torch.equal(got[part][key], value), (part, key)
    for key, value in want["optimizer"]["state"].items():
        for name, tensor in value.items():
            assert torch.equal(got["optimizer"]["state"][key][name], tensor)
    assert torch.equal(got["rng"], want["rng"])
