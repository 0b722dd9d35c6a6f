"""JASCO training of the port (`solvers/jasco.py`) and the U-Net
transformer's layer dropout against the JAX package on the CPU, on the debug
JASCO (dim 16, 2 layers with a skip, text by lookup table, chords) over the
debug codec:

- one `run_step` against `make_jasco_train_step` on the same weights (the
  port's, carried by the JAX package's converter), the same latents and
  conditions (rows with and without chords) and the same t and z0: the
  loss, every gradient and the AdamW update (optax's decay of 1e-4);
- `evaluate`'s t buckets 0.1 / 0.5 / 0.9 with the JAX z0 draws, and a
  warm start from a JAX training state;
- layer dropout: p 0 is the deterministic forward, p 1 zeroes every skip
  (the JAX layer at p 1), and a seeded generator replays its choices;
- a config with `transformer_lm` builds its model, whose drum conditioner
  takes each row's `self_wav`;
- the registry: `compression`, `diffusion` and `jasco` build,
  `watermarking` with an mp3 attack raises (slice H).

Tolerances: latents atol 1e-5; the loss and the bucket losses rtol 1e-5;
each gradient within 1e-4 of its largest entry (f32 attention and layer
norms, sums in another order); the AdamW update atol 1e-6 where a gradient
is above 1e-3 of its largest entry (elsewhere within lr plus the decay and
the weight's f32 rounding); layer-dropout outputs atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules.unet_transformer import \
    UnetTransformer as JaxUnetTransformer
from audiocraft_tpu.solvers import jasco as jjasco
from audiocraft_tpu.utils import checkpoint as jckpt
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.data import AudioMeta, JascoInfo
from audiocraft_tpu_torch.modules.conditioners import (SymbolicCondition,
                                                       WavCondition)
from audiocraft_tpu_torch.modules.unet_transformer import UnetTransformer
from audiocraft_tpu_torch.solvers import (CompressionSolver, DiffusionSolver,
                                          JascoSolver, get_solver)
from audiocraft_tpu_torch.solvers import jasco as tjasco
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_jasco import (DEBUG_SPECS, SMALL_CFG, _jax_flow_model,
                                    _state)
from tests.test_torch_mbd import (_jax_codec, _one_torch_thread,  # noqa: F401
                                   _perturbed)

TEXTS = ["funky drums and bass", "sad piano"]
LR = 1e-4
# upstream's chord conditioner keeps an unused projection; the JAX one has none
NO_JAX_PARAMETER = "condition_provider.conditioners.chords.output_proj."


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _JaxInfo:
    """What the JAX solver reads of a batch's info."""

    def __init__(self, text, chords=None):
        self.text, self.chords = text, chords

    def to_condition_attributes(self):
        symbolic = {} if self.chords is None else {
            "chords": jcond.SymbolicCondition(frame_chords=self.chords)}
        return jcond.ConditioningAttributes(text={"description": self.text},
                                            symbolic=symbolic)


def _batch(frames=10, seed=0):
    """2 rows of 0.4 s: the first with seeded frame chords, the second
    without (the solver's null chord 0), in each package's info type."""
    rs = np.random.RandomState(seed)
    wav = (rs.randn(2, 1, frames * 1280) * 0.1).astype(np.float32)
    chords = rs.randint(0, 194, frames).astype(np.int32)
    meta = AudioMeta(path="clip.wav", duration=0.4, sample_rate=32000)
    infos = [JascoInfo(meta=meta, seek_time=0.0, n_frames=frames * 1280,
                       total_frames=frames * 1280, sample_rate=32000,
                       channels=1, description=text,
                       chords=SymbolicCondition(frame_chords=chords)
                       if i == 0 else None)
             for i, text in enumerate(TEXTS)]
    jinfos = [_JaxInfo(TEXTS[0], chords), _JaxInfo(TEXTS[1])]
    return wav, infos, jinfos


@pytest.fixture(scope="module")
def pair():
    """The port's JASCO solver (debug model, perturbed) and the JAX solver
    (built without its constructor, which inits the debug model and codec)
    over the same flow model's weights and the same codec."""
    solver = get_solver({"solver": "jasco", "seed": 0, "optim": {"lr": LR}},
                        device="cpu")
    _perturbed(solver.model, seed=3)
    jsolver = object.__new__(jjasco.JascoSolver)
    jsolver.model = _jax_flow_model()
    jsolver.compression_model, jsolver.compression_variables = _jax_codec(
        solver.compression_model)
    params = jax.tree.map(jnp.asarray, torch_port.convert_flow_matching_state(
        _state(solver.model), num_layers=2, norm_first=True,
        skip_connections=True, conditioner_specs=DEBUG_SPECS))
    return solver, jsolver, params


def _t_z0(rng, shape):
    rng_t, rng_z = jax.random.split(rng)
    return (np.array(jax.random.uniform(rng_t, (shape[0],))),
            np.array(jax.random.normal(rng_z, shape)))


def test_run_step_matches_the_jax_step(pair, monkeypatch):
    solver, jsolver, params = pair
    wav, infos, jinfos = _batch()
    latents, jtokenized = jsolver._tokenize_batch(wav, jinfos)
    got_latents, _ = solver._tokenize_batch(wav, infos)
    np.testing.assert_allclose(got_latents.numpy(), np.asarray(latents),
                               atol=1e-5, rtol=0)
    adamw = optax.adamw(LR)
    keep = optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), adamw.init(p)),
        lambda g, s, p=None: (adamw.update(g, s[1], p)[0],
                              (g, adamw.update(g, s[1], p)[1])))
    state = jjasco.JascoTrainState(step=jnp.zeros((), jnp.int32),
                                   params=jax.tree.map(jnp.copy, params),
                                   opt_state=keep.init(params))
    rng = jax.random.PRNGKey(4)
    new_state, jm = jjasco.make_jasco_train_step(jsolver.model, keep)(
        state, latents, jtokenized, rng)
    t, z0 = _t_z0(rng, latents.shape)
    loss_fn = tjasco.flow_matching_loss
    monkeypatch.setattr(tjasco, "flow_matching_loss", lambda *a, **kw: loss_fn(
        *a, **kw, t=torch.from_numpy(t), z0=torch.from_numpy(z0)))
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    metrics = solver.run_step(0, (wav, infos), {})
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    want_grads = jax_weights.flow_matching_state(solver.model,
                                                 _np(new_state.opt_state[0]))
    updated = jax_weights.flow_matching_state(solver.model,
                                              _np(new_state.params))
    for name, p in solver.model.named_parameters():
        if name.startswith(NO_JAX_PARAMETER):
            continue
        want = want_grads[name]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=name)
        large = np.abs(want) > 1e-3 * scale
        delta = (p.detach() - before[name]).numpy()
        want_delta = updated[name] - before[name].numpy()
        np.testing.assert_allclose(delta[large], want_delta[large], atol=1e-6,
                                   rtol=0, err_msg=name)
        bound = LR * (1 + 1e-4 * float(before[name].abs().max())) + 1e-6
        assert np.abs(delta).max() <= bound, name


def test_evaluate_buckets_match_jax(pair, monkeypatch):
    solver, jsolver, params = pair
    wav, infos, jinfos = _batch(seed=1)
    jsolver.dataloaders = {"evaluate": [(wav, jinfos)]}
    jsolver.state = jjasco.JascoTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, torch_port.convert_flow_matching_state(
            _state(solver.model), num_layers=2, norm_first=True,
            skip_connections=True, conditioner_specs=DEBUG_SPECS)),
        opt_state=None)
    jsolver._rng = jax.random.PRNGKey(8)
    want = jsolver.evaluate()
    rng, draws = jax.random.PRNGKey(8), []
    for _ in range(3):
        rng, r = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(r, (2, 10, 32))))
    monkeypatch.setattr(tjasco, "randn", lambda shape, g, d: torch.from_numpy(
        draws.pop(0)))
    solver.dataloaders["evaluate"] = [(wav, infos)]
    got = solver.evaluate()
    assert not draws and got.keys() == {"t_low", "t_mid", "t_high", "loss"}
    for key in got:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5,
                                   err_msg=key)


def test_warm_start_from_a_jax_checkpoint(pair, tmp_path):
    """A JAX JASCO training state saved by the JAX package's
    `save_checkpoint`, given as `continue_from`: the flow model's weights
    (the chords' unused projection, which JAX lacks, keeps the port's)."""
    solver, _, params = pair
    path = tmp_path / "jax" / "checkpoint.th"
    path.parent.mkdir()
    jckpt.save_checkpoint(jjasco.JascoTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=optax.adamw(LR).init(params)), path)
    fresh = get_solver({"solver": "jasco", "seed": 0,
                        "folder": str(tmp_path / "xp")}, device="cpu")
    assert fresh.restore(continue_from=str(path.parent)) and fresh.epoch == 0
    want = jax_weights.flow_matching_state(fresh.model, _np(params))
    for key, value in fresh.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def _unet_pair(p):
    torch.manual_seed(0)
    port = _perturbed(UnetTransformer(16, 4, 4, dim_feedforward=64,
                                      norm_first=True, skip_connections=True,
                                      layer_dropout_p=p), seed=1)
    tree = torch_port._convert_transformer_layers(
        _state(port), "", 4, cross_attention=False, skip_projections=True)
    jmodel = JaxUnetTransformer(d_model=16, num_heads=4, num_layers=4,
                                dim_feedforward=64, norm_first=True,
                                skip_connections=True, layer_dropout_p=p)
    return port, jmodel, tree


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_layer_dropout_at_its_ends_matches_jax(p):
    """p 0: the training forward is the deterministic one; p 1: every skip
    is zero, as the JAX layer's training forward at p 1."""
    port, jmodel, tree = _unet_pair(p)
    x = np.random.RandomState(2).randn(2, 9, 16).astype(np.float32)
    want, _ = jmodel.apply({"params": tree}, jnp.asarray(x),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x),
                           generator=torch.Generator().manual_seed(0))
        deterministic = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.equal(got, deterministic) == (p == 0.0)


def test_layer_dropout_replays_from_a_seeded_generator():
    port, _, _ = _unet_pair(0.5)
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 5, 16).astype(
        np.float32))
    port.train()
    with torch.no_grad():
        outs = [port(x, generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1, 2, 3, 4, 5)]
    assert torch.equal(outs[0], outs[1])
    assert len({tuple(o.flatten().tolist()) for o in outs}) > 1


def test_config_model_trains_on_drums_and_chords():
    """`transformer_lm` in the config builds that model; each row's
    `self_wav` goes to its drum conditioner (the solver's codec bound to
    it), and the step reaches the drum projection."""
    cfg = dict(SMALL_CFG, solver="jasco", seed=0)
    solver = get_solver(cfg, device="cpu")
    assert solver.model.emb.in_features == 32 + 8 + 8 + 4
    assert solver.model.conditioners["self_wav"].__dict__["codec"] \
        is solver.compression_model
    wav, infos, _ = _batch(seed=2)
    for info, row in zip(infos, wav):
        info.self_wav = WavCondition(torch.from_numpy(row[None]),
                                     torch.tensor([row.shape[-1]]), [32000],
                                     [None])
    metrics = solver.run_step(0, (wav, infos), {})
    assert np.isfinite(metrics["loss"].item())
    drum_proj = solver.model.conditioners["self_wav"].output_proj.weight
    assert drum_proj.grad is not None and drum_proj.grad.abs().sum() > 0


@pytest.mark.parametrize("name, cls", [("diffusion", DiffusionSolver),
                                       ("jasco", JascoSolver),
                                       ("compression", CompressionSolver)])
def test_get_solver_builds(name, cls):
    cfg = {"solver": name, "seed": 0, "sample_rate": 32000}
    if name == "diffusion":
        cfg["diffusion_unet"] = dict(hidden=8, depth=2, codec_dim=32)
    solver = get_solver(cfg, device="cpu")
    assert type(solver) is cls and solver.generate() == {}
    # the generate stage (the sample manager) is ported; its output is
    # checked in `test_torch_data_train.py`


@pytest.mark.parametrize("name, where", [
    # the id kept from when AudioSeal training was slice G's to port: the
    # solver builds, and its mp3 and aac attacks go through the libav
    # binding, which raises where it cannot be built
    pytest.param("watermarking", "libav binding", id="watermarking-slice G")])
def test_unported_solvers_raise(name, where):
    from audiocraft_tpu_torch.data import _native
    cfg = {"solver": name, "aug_weights": {"mp3_compression": 0.3},
           "audio_effects": {"mp3_compression": {}}}
    if _native.av_available():
        assert "mp3_compression" in get_solver(cfg, device="cpu").augmentations
    else:
        with pytest.raises(RuntimeError, match=where):
            get_solver(cfg, device="cpu")
