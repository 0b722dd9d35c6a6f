"""The port's MAGNeT training (`solvers/magnet.py`) vs the JAX package on the
CPU: the mask-rate look-up table and the span masks from the same numpy
RandomState, and one solver step on the debug MAGNeT LM with the stage and
the mask given to both (the JAX solver draws its stage from Python's
unseeded `random`), its CE and every gradient; then the registry, the
seeded draws and `evaluate`.

Tolerances: the table and the masks equal; CE rtol 1e-5 and each gradient
within 1e-5 of its largest entry (f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.solvers import magnet as jmagnet
from audiocraft_tpu.solvers import musicgen as jmusicgen
from audiocraft_tpu_torch.modules import conditioners as tcond
from audiocraft_tpu_torch.solvers import builders as solver_builders
from audiocraft_tpu_torch.solvers import magnet as tmagnet
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["electro dance with a fast beat", "calm piano"]


@pytest.mark.parametrize("T, L", [(10, 3), (500, 3), (37, 5)])
def test_mask_rate_table_matches_jax(T, L):
    np.testing.assert_array_equal(tmagnet.calc_mean_maskrate_to_u_LUT(T, L),
                                  jmagnet.calc_mean_maskrate_to_u_LUT(T, L))


@pytest.mark.parametrize("span_len", [1, 3])
def test_masks_match_jax_from_the_same_random_state(span_len):
    B, T = 4, 50
    probs = np.cos(np.random.RandomState(0).uniform(0, 1, B) * np.pi / 2)
    lut = jmagnet.calc_mean_maskrate_to_u_LUT(T, span_len)
    ours, theirs = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        if span_len == 1:
            got = tmagnet.non_spans_mask(ours, probs, B, T)
            want = jmagnet.non_spans_mask(theirs, probs, B, T)
        else:
            got = tmagnet.spans_mask(ours, probs, B, T, span_len, lut)
            want = jmagnet.spans_mask(theirs, probs, B, T, span_len, lut)
        np.testing.assert_array_equal(got, want)
    assert got.any(axis=1).all()


@pytest.fixture(scope="module")
def debug_pair():
    jmodel, params = jbuilders.get_debug_magnet_lm_model()
    solver = tmagnet.MagnetSolver({"seed": 0, "solver": "magnet"},
                                  device="cpu")
    jax_weights.load_lm(solver.model, jax.tree.map(np.asarray, params))
    solver.optimizer = solver_builders.get_optimizer(
        solver.model.parameters(), {"lr": 0.0})
    return jmodel, params, solver


def _jax_inputs(codes, stage, stage_mask, padding, special):
    """The JAX `MagnetSolver.run_step`'s inputs for a stage and a mask."""
    B, K, T = codes.shape
    mask = np.zeros((B, K, T), bool)
    mask[:, stage] = stage_mask
    mask[:, stage + 1:] = True
    loss_mask = np.zeros((B, K, T), bool)
    loss_mask[:, stage] = stage_mask
    loss_mask &= padding[:, None, :]
    return np.where(mask, special, codes), loss_mask


@pytest.mark.parametrize("stage", [0, 2])
def test_magnet_step_matches_jax(debug_pair, stage):
    """The JAX solver's own per-stage step (`_get_magnet_step`, with its
    stage attention bias) gives the CE and the gradients (kept by an
    optimizer that updates nothing)."""
    jmodel, params, solver = debug_pair
    rs = np.random.RandomState(stage)
    B, T = 2, 20
    codes = rs.randint(0, jmodel.card, (B, 4, T))
    padding = np.ones((B, T), bool)
    padding[1, -4:] = False
    stage_mask = jmagnet.spans_mask(
        rs, np.array([0.7, 0.3]), B, T, 3,
        jmagnet.calc_mean_maskrate_to_u_LUT(T, 3))
    inputs, loss_mask = _jax_inputs(codes, stage, stage_mask, padding,
                                    jmodel.special_token_id)
    tokenized = jlm.tokenize_conditions(
        jmodel, [jcond.ConditioningAttributes(text={"description": t})
                 for t in TEXTS])
    # an optimizer that keeps the gradients as its state and updates nothing
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jsolver = object.__new__(jmagnet.MagnetSolver)
    jsolver.model, jsolver.optimizer = jmodel, keep
    jsolver._magnet_steps = {}
    step = jsolver._get_magnet_step(stage, T)
    state = jmusicgen.init_train_state(jmodel, jax.tree.map(jnp.copy, params),
                                       keep)
    new_state, jmetrics = step(state, jnp.asarray(inputs), jnp.asarray(codes),
                               jnp.asarray(loss_mask), tokenized)
    expected = jax_weights.lm_state(solver.model, jax.tree.map(
        np.asarray, dict(params, params=new_state.opt_state)))

    tokenized_port = solver.model.condition_provider.tokenize(
        [tcond.ConditioningAttributes(text={"description": t}) for t in TEXTS])
    metrics = solver.masked_step(torch.from_numpy(codes), tokenized_port,
                                 torch.from_numpy(padding), stage, stage_mask)
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]),
                               rtol=1e-5)
    for name, p in solver.model.named_parameters():
        want = expected[name]
        scale = max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name)


def test_registry_and_seeded_draws():
    """`magnet` and `audio_magnet` build through `get_solver`; two solvers
    of one seed draw the same stages and masks, so their steps agree."""
    solvers = [solver_builders.get_solver({"seed": 3, "solver": "magnet"},
                                          device="cpu") for _ in range(2)]
    assert type(solvers[0]).__name__ == "MagnetSolver"
    audio = solver_builders.get_solver(
        {"seed": 3, "solver": "audio_magnet", "sample_rate": 16000},
        device="cpu")
    assert isinstance(audio, tmagnet.AudioMagnetSolver)
    assert audio.DATASET_TYPE == "sound"
    assert audio.compression_model.sample_rate == 16000
    rs = np.random.RandomState(1)
    batch = {"codes": torch.from_numpy(rs.randint(0, 400, (2, 4, 16))),
             "tokenized": solvers[0].model.condition_provider.tokenize(
                 [tcond.ConditioningAttributes(text={"description": t})
                  for t in TEXTS])}
    ces = [[float(s.run_step(i, batch, {})["ce"]) for i in range(3)]
           for s in solvers]
    assert ces[0] == ces[1] and all(np.isfinite(ces[0]))
    assert np.isfinite(float(audio.run_step(0, batch, {})["ce"]))


def test_evaluate_scores_every_stage_deterministically(debug_pair):
    """`evaluate` averages the CE of every stage of each batch, with masks
    from a RandomState of the config's seed (the same at each call) and
    without touching the training draws."""
    _, _, solver = debug_pair
    rs = np.random.RandomState(2)
    codes = torch.from_numpy(rs.randint(0, 400, (2, 4, 16)))
    tokenized = solver.model.condition_provider.tokenize(
        [tcond.ConditioningAttributes(text={"description": t}) for t in TEXTS])
    solver.dataloaders["evaluate"] = [{"codes": codes, "tokenized": tokenized}]
    mask_state = solver._mask_rng.get_state()[1].copy()
    first, second = solver.evaluate(), solver.evaluate()
    assert first == second
    np.testing.assert_array_equal(solver._mask_rng.get_state()[1], mask_state)
    draws = np.random.RandomState(0)  # the config's seed
    ces = [float(solver.masked_step(codes, tokenized, None, stage,
                                    solver._draw_mask(draws, 2, 16),
                                    training=False)["ce"])
           for stage in range(4)]
    np.testing.assert_allclose(first["ce"], np.mean(ces), rtol=1e-6)
    np.testing.assert_allclose(first["ppl"], np.exp(first["ce"]), rtol=1e-6)
    del solver.dataloaders["evaluate"]
