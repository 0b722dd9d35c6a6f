"""The port's LM training slice vs the JAX package on the CPU, in f32, at small
sizes: `compute_predictions`, the cross-entropy and every parameter gradient
of a train step, AdamW/Adam with clipping and each LR schedule against optax,
the config loader, the condition dropouts and metadata, and the solver.

Tolerances: logits atol 1e-5 / rtol 1e-4; CE and gradients atol 1e-5 /
rtol 1e-4 (f32; sums in another order); optimizer trajectories atol 1e-6
(torch clips by max_norm / (norm + 1e-6), optax by max_norm / norm, and Adam
normalises that scale away up to eps); LR schedules rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from audiocraft_tpu import config as jconfig
from audiocraft_tpu.data.audio_dataset import AudioMeta as JaxAudioMeta
from audiocraft_tpu.data.music_dataset import MusicInfo as JaxMusicInfo
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.models.presets import musicgen_lm as jax_musicgen_lm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.optim import lr_schedulers as jsched
from audiocraft_tpu.solvers import builders as jsolver_builders
from audiocraft_tpu.solvers import musicgen as jmg
from audiocraft_tpu_torch import config
from audiocraft_tpu_torch.data import AudioInfo, AudioMeta, MusicInfo
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.models.presets import musicgen_lm
from audiocraft_tpu_torch.modules import conditioners as tcond
from audiocraft_tpu_torch.modules import transformer as ttr
from audiocraft_tpu_torch.ops.flash_causal_attention import flash_causal_attention
from audiocraft_tpu_torch.optim import lr_schedulers as tsched
from audiocraft_tpu_torch.solvers import builders as solver_builders
from audiocraft_tpu_torch.solvers import musicgen as tmg
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["warm analog synth arpeggio", "fast drum and bass"]
CARD = 64


def _jax_toy_lm():
    """D = 64 heads (dim 128, 2 heads): eligible for the flash kernel."""
    cond = {"description": jcond.LUTConditioner(
        n_bins=256, dim=128, output_dim=128, tokenizer="whitespace")}
    return jax_musicgen_lm("xsmall", card=CARD, dim=128, num_heads=2,
                           conditioners=cond)


def _port_toy_lm():
    cond = {"description": tcond.LUTConditioner(n_bins=256, dim=128,
                                                 output_dim=128)}
    return musicgen_lm("xsmall", card=CARD, dim=128, num_heads=2,
                       conditioners=cond)


@pytest.fixture(scope="module", params=["debug", "toy_d64"])
def lm_pair(request):
    if request.param == "debug":
        jmodel, params = jbuilders.get_debug_lm_model()
        port = builders.get_debug_lm_model(device="cpu")
    else:
        jmodel = _jax_toy_lm()
        params = jlm.init_lm_params(jmodel, jax.random.PRNGKey(0))
        port = _port_toy_lm()
    jax_weights.load_lm(port, jax.tree.map(np.asarray, params))
    return jmodel, params, port


def _codes(card, B=2, T=11, seed=0):
    codes = np.random.RandomState(seed).randint(0, card, (B, 4, T))
    codes[1, :, -3:] = card  # padding, as mask_padding writes it
    return codes


def _attrs(cls):
    return [cls(text={"description": t}) for t in TEXTS]


def test_compute_predictions_match_jax(lm_pair):
    jmodel, params, port = lm_pair
    codes = _codes(port.card)
    tokenized = jlm.tokenize_conditions(jmodel, _attrs(jcond.ConditioningAttributes))
    @jax.jit
    def predict(variables):
        ct = jmodel.apply(variables, tokenized,
                          method=jlm.LMModel.compute_conditions)
        return jmodel.apply(variables, jnp.asarray(codes), ct,
                            method=jlm.LMModel.compute_predictions)
    expected = predict(params)
    tct = port.compute_conditions(
        port.condition_provider.tokenize(_attrs(tcond.ConditioningAttributes)))
    with torch.no_grad():
        got = port.compute_predictions(torch.from_numpy(codes), tct)
    assert got.logits.shape == (2, 4, 11, port.card)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(expected.mask))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(expected.logits),
                               atol=1e-5, rtol=1e-4)
    # invalid pattern positions hold 0.0, not NaN
    assert torch.isfinite(got.logits).all()
    assert (got.logits[~got.mask] == 0).all()


def test_train_step_ce_and_every_gradient_match_jax(lm_pair):
    jmodel, params, port = lm_pair
    codes = _codes(port.card, seed=1)
    tokenized = jlm.tokenize_conditions(jmodel, _attrs(jcond.ConditioningAttributes))

    def loss(variables):  # the JAX solver's loss_fn (`solvers/musicgen.py:101`)
        ct = jmodel.apply(variables, tokenized,
                          method=jlm.LMModel.compute_conditions)
        out = jmodel.apply(variables, jnp.asarray(codes), ct,
                           method=jlm.LMModel.compute_predictions)
        mask = out.mask & (codes != jmodel.special_token_id)
        return jmg.compute_cross_entropy(out.logits, jnp.asarray(codes), mask)

    (ce, ce_q), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    expected = jax_weights.lm_state(port, jax.tree.map(np.asarray, grads))
    opt = solver_builders.get_optimizer(port.parameters(), {"lr": 0.0})
    metrics = tmg.train_step(port, opt, torch.from_numpy(codes),
                             port.condition_provider.tokenize(
                                 _attrs(tcond.ConditioningAttributes)))
    np.testing.assert_allclose(metrics["ce"].item(), float(ce), atol=1e-5,
                               rtol=1e-4)
    for k in range(4):
        np.testing.assert_allclose(metrics[f"ce_q{k + 1}"].item(),
                                   float(ce_q[k]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(optax.global_norm(grads)), rtol=1e-4)
    named = dict(port.named_parameters())
    assert set(named) == set(expected)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), expected[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_bf16_autocast_feeds_the_kernel_route_bf16(monkeypatch):
    """Mixed precision as the JAX package's `dtype=bf16, param_dtype=f32`:
    f32 parameters, and the flash route receives bf16 q/k/v."""
    seen = []

    def spy(q, k, v):
        seen.append((q.dtype, k.dtype, v.dtype))
        return flash_causal_attention(q, k, v)
    monkeypatch.setattr(ttr, "flash_causal_attention", spy)
    port = _port_toy_lm()
    opt = solver_builders.get_optimizer(port.parameters(), {"lr": 1e-3})
    m = tmg.train_step(port, opt, torch.from_numpy(_codes(CARD)),
                       port.condition_provider.tokenize(
                           _attrs(tcond.ConditioningAttributes)),
                       compute_dtype=torch.bfloat16)
    assert torch.isfinite(m["ce"])
    assert seen == [(torch.bfloat16,) * 3] * port.num_layers
    assert all(p.dtype == torch.float32 for p in port.parameters())


@pytest.mark.parametrize("pattern", ["delay", "parallel"])
def test_training_pattern_sequences_match_jax_at_30_s(pattern):
    """`build_pattern_sequence` and `revert_pattern_logits` with
    keep_only_valid_steps=True at the 30 s training shape (1500 frames)."""
    from audiocraft_tpu.modules import patterns as jpat
    from audiocraft_tpu_torch.modules import patterns as tpat
    T, card = 1500, 2048
    make = {"delay": lambda m: m.DelayedPatternProvider(4),
            "parallel": lambda m: m.ParallelPatternProvider(4)}[pattern]
    jp, tp_ = make(jpat).get_pattern(T), make(tpat).get_pattern(T)
    rs = np.random.RandomState(5)
    codes = rs.randint(0, card, (2, 4, T))
    jseq, jidx, jmask = jp.build_pattern_sequence(jnp.asarray(codes), card,
                                                  keep_only_valid_steps=True)
    seq, idx, mask = tp_.build_pattern_sequence(torch.from_numpy(codes), card,
                                                keep_only_valid_steps=True)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    logits = rs.randn(1, 3, 4, seq.shape[-1]).astype(np.float32)
    jl, jidx, jmask = jp.revert_pattern_logits(jnp.asarray(logits), 0.0,
                                               keep_only_valid_steps=True)
    tl, idx, mask = tp_.revert_pattern_logits(torch.from_numpy(logits), 0.0,
                                              keep_only_valid_steps=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(mask, np.asarray(jmask))


def test_cross_entropy_and_padding_mask_match_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 4, 9, 16).astype(np.float32)
    targets = rs.randint(0, 17, (2, 4, 9))  # 16 is the special token
    mask = (rs.rand(2, 4, 9) > 0.3) & (targets != 16)
    mask[:, 2] = False  # an empty codebook
    ce, ce_q = jmg.compute_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets), jnp.asarray(mask))
    got, got_q = tmg.compute_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(targets),
                                           torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ce), rtol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ce_q), rtol=1e-6)
    padding = rs.rand(2, 9) > 0.4
    np.testing.assert_array_equal(
        tmg.mask_padding(torch.from_numpy(targets), torch.from_numpy(padding),
                         16).numpy(),
        np.asarray(jmg.mask_padding(jnp.asarray(targets), jnp.asarray(padding),
                                    16)))


class _Toy(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.transformer = nn.Module()
        self.transformer.w = nn.Parameter(torch.from_numpy(arrays["transformer"]))
        self.emb = nn.Module()
        self.emb.w = nn.Parameter(torch.from_numpy(arrays["emb"]))


@pytest.mark.parametrize("case", ["none", "cosine", "polynomial_decay",
                                  "inverse_sqrt", "linear_warmup",
                                  "cosine_groups", "adam", "make_optimizer",
                                  "dadam", "dadam_groups"])
def test_optimizer_matches_optax_over_10_steps(case):
    rs = np.random.RandomState(4)
    arrays = {"transformer": rs.randn(4, 3).astype(np.float32),
              "emb": rs.randn(5).astype(np.float32)}
    # D-Adaptation's estimate grows only under small gradients
    scale = 0.006 if case.startswith("dadam") else 0.6
    grads = [{k: (scale * rs.randn(*v.shape)).astype(np.float32)
              for k, v in arrays.items()} for _ in range(10)]
    sched = case.split("_groups")[0] if case not in (
        "adam", "make_optimizer", "dadam", "dadam_groups") else "cosine"
    optimizer = case.split("_")[0] if case.startswith(("adam", "dadam")) \
        else "adamw"
    cfg = {"optimizer": optimizer, "lr": 1e-2,
           "adam": {"betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1},
           "max_norm": 1.0, "lr_scheduler": None if sched == "none" else sched,
           sched: {"warmup": 3, "lr_min_ratio": 0.1, "end_lr": 1e-3,
                   "power": 2.0, "warmup_init_lr": 1e-3}}
    overrides = {"transformer": {"lr": 3e-2, "weight_decay": 0.0}}
    initial = {k: v.copy() for k, v in arrays.items()}
    module = _Toy(arrays)
    if case == "make_optimizer":
        schedule = tsched.cosine_with_warmup(1e-2, 3, 10)
        jopt = jmg.make_optimizer(jsched.cosine_with_warmup(1e-2, 3, 10))
        opt = tmg.make_optimizer(module.parameters(), schedule)
    elif case.endswith("_groups"):
        jopt = jsolver_builders.get_optimizer(
            cfg, 10, param_groups=jsolver_builders.get_optim_parameter_groups(
                arrays, overrides))
        opt = solver_builders.get_optimizer(
            solver_builders.get_optim_parameter_groups(module, overrides), cfg,
            10)
    else:
        jopt = jsolver_builders.get_optimizer(cfg, 10)
        opt = solver_builders.get_optimizer(module.parameters(), cfg, 10)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    state = jopt.init(params)
    for g in grads:
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     state, params)
        params = optax.apply_updates(params, updates)
        module.transformer.w.grad = torch.tensor(g["transformer"])
        module.emb.w.grad = torch.tensor(g["emb"])
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
    np.testing.assert_allclose(module.transformer.w.detach().numpy(),
                               np.asarray(params["transformer"]), atol=1e-6)
    np.testing.assert_allclose(module.emb.w.detach().numpy(),
                               np.asarray(params["emb"]), atol=1e-6)
    if optimizer == "dadam":  # its steps are of order d0 = 1e-6: compare them
        assert all(float(g["d"]) > 1e-6 for g in opt.optimizer.param_groups)
        for name, w in (("transformer", module.transformer.w),
                        ("emb", module.emb.w)):
            moved = np.asarray(params[name]) - initial[name]
            assert np.abs(moved).max() > 1e-6
            np.testing.assert_allclose(w.detach().numpy() - initial[name],
                                       moved, rtol=1e-4, atol=1e-11)


@pytest.mark.parametrize("name, kw", [
    ("cosine", dict(warmup=4, lr_min_ratio=0.1, cycle_length=1.0)),
    ("polynomial_decay", dict(warmup=4, end_lr=1e-4, power=2.0,
                              zero_lr_warmup_steps=2)),
    ("inverse_sqrt", dict(warmup=4, warmup_init_lr=1e-4)),
    ("linear_warmup", dict(warmup=4)), ("none", {})])
def test_lr_schedules_match_jax(name, kw):
    theirs = jsched.get_lr_scheduler(name, 1e-2, 20, kw)
    ours = tsched.get_lr_scheduler(name, 1e-2, 20, kw)
    for step in range(30):
        want = float(theirs(step)) if callable(theirs) else theirs
        np.testing.assert_allclose(ours(step), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["solver/musicgen/default",
                                  "solver/musicgen/debug",
                                  "solver/musicgen/musicgen_base_32khz"])
def test_config_loader_matches_jax(name):
    ours, theirs = config.load_config(name), jconfig.load_config(name)
    assert ours == theirs
    overrides = ["dataset.batch_size=16", "transformer_lm.dtype=bfloat16",
                 "optim.lr=3e-4", "fuser.cross=[\"description\"]"]
    assert config.apply_overrides(ours, overrides) == \
        jconfig.apply_overrides(theirs, overrides)
    assert ours == theirs


def test_condition_dropouts_draw_as_jax():
    """Same numpy seed, same order of draws: the same decisions."""
    kinds = {"text": {"description": 0.5, "genre": 0.3}}
    mk = [dict(text={"description": f"tune {i}", "genre": "rock"})
          for i in range(3)]
    ours = tcond.AttributeDropout(kinds)
    theirs = jcond.AttributeDropout(kinds)
    ours_cfg = tcond.ClassifierFreeGuidanceDropout(0.4)
    theirs_cfg = jcond.ClassifierFreeGuidanceDropout(0.4)
    dropped = 0
    for _ in range(40):
        a = ours([tcond.ConditioningAttributes(**m) for m in mk])
        b = theirs([jcond.ConditioningAttributes(**m) for m in mk])
        assert [x.text for x in a] == [x.text for x in b]
        a = ours_cfg([tcond.ConditioningAttributes(**m) for m in mk])
        b = theirs_cfg([jcond.ConditioningAttributes(**m) for m in mk])
        assert [x.text for x in a] == [x.text for x in b]
        dropped += a[0].text["description"] is None
    assert 5 < dropped < 30
    ours.training = False
    kept = ours([tcond.ConditioningAttributes(**mk[0])])
    assert kept[0].text == mk[0]["text"]


def test_music_info_conditions_match_jax():
    fields = dict(seek_time=1.5, n_frames=100, total_frames=120,
                  sample_rate=32000, channels=1, title="t", bpm=120.0,
                  moods=["calm", "dark"], description="a calm piano")
    ours = MusicInfo(meta=AudioMeta("x.wav", 2.0, 32000), **fields)
    theirs = JaxMusicInfo(meta=JaxAudioMeta("x.wav", 2.0, 32000), **fields)
    a, b = ours.to_condition_attributes(), theirs.to_condition_attributes()
    assert set(a.text) == set(b.text)
    for key in a.text:
        if key != "meta":
            assert a.text[key] == b.text[key], key
    assert a.wav == {"self_wav": None} and set(b.wav) == {"self_wav"}
    info = AudioInfo(AudioMeta("x.wav", 2.0, 32000), 0.0, 10, 10, 32000, 1)
    assert MusicInfo(**info.to_dict(), description="d").description == "d"


def _fake_batch(B=2, T=12800, sr=32000):
    rs = np.random.RandomState(0)
    wav = (0.1 * rs.randn(B, 1, T)).astype(np.float32)
    infos = [MusicInfo(**AudioInfo(AudioMeta("x.wav", T / sr, sr), 0.0,
                                   T - 2560 * i, T, sr, 1).to_dict(),
                       description="test tune") for i in range(B)]
    return wav, infos


def test_musicgen_solver_steps_on_the_debug_model():
    """As the JAX package's `tests/models/test_solvers.py`: two run_steps on
    (wav, infos) give a finite CE; the cached-batch dict path, one train
    stage and the evaluate stage run too."""
    solver = tmg.MusicGenSolver({"seed": 0, "sample_rate": 32000,
                                 "compression_model_checkpoint": "debug"},
                                device="cpu")
    batch = _fake_batch()
    first = solver.run_step(0, batch, {})
    second = solver.run_step(1, batch, {})
    assert np.isfinite(first["ce"].item()) and np.isfinite(second["ce"].item())
    codes, tokenized, padding = solver._prepare_tokens_and_attributes(batch)
    assert codes.shape == (2, 4, 10) and padding[0].all()
    assert padding[1].tolist() == [True] * 8 + [False] * 2
    assert (codes[1, :, -2:] == solver.model.special_token_id).all()
    solver.dataloaders["train"] = [({"codes": codes, "tokenized": tokenized,
                                     "padding_mask": padding},)] * 3
    metrics = solver.run_one_stage("train")
    assert np.isfinite(metrics["ce"]) and metrics["grad_norm"] > 0
    epoch = solver.run_epoch("train", max_updates=2)
    assert set(epoch) == set(metrics) and np.isfinite(epoch["ppl"])
    codes, tokenized, _ = solver._prepare_tokens_and_attributes(
        batch, training=False)
    evaluated = tmg.eval_step(solver.model, codes, tokenized)
    assert set(evaluated) == {"ce", "ppl", "ce_q1", "ce_q2", "ce_q3", "ce_q4"}
    assert np.isfinite(evaluated["ce"].item()) and not solver.model.training
    solver.dataloaders["evaluate"] = [batch]
    evaluated = solver.run_one_stage("evaluate")
    assert set(evaluated) == {"ce", "ppl", "ce_q1", "ce_q2", "ce_q3", "ce_q4"}
    assert np.isfinite(evaluated["ce"])


def test_solver_from_the_debug_config_freezes_t5():
    cfg = config.load_config("solver/musicgen/debug")
    solver = solver_builders.get_solver(cfg, device="cpu")
    cond = solver.model.condition_provider.conditioners["description"]
    trained = {id(p) for p in solver.optimizer.params}
    assert not any(id(p) in trained for p in cond.t5.parameters())
    assert all(id(p) in trained for p in cond.output_proj.parameters())
    m = solver.run_step(0, _fake_batch(), {})
    assert np.isfinite(m["ce"].item())
    assert all(p.grad is None for p in cond.t5.parameters())
    assert cond.output_proj.weight.grad is not None
    # the JAX solver reads `optim.lr_scheduler`, which this config lacks
    assert solver.optimizer.optimizer.param_groups[0]["lr"] == cfg["optim"]["lr"]


@pytest.mark.parametrize("option", [
    {"kv_repeat": 2}, {"positional_embedding": "rope", "xpos": True},
    {"layer_scale": 0.1}, {"qk_layer_norm": True}])
def test_lm_options_config_trains(option):
    """The transformer options the port once refused build through the
    solver config and take a train step (their logits against the JAX
    package's are held in `test_torch_lm_options.py`)."""
    cfg = config.load_config("solver/musicgen/debug")
    cfg["transformer_lm"].update(option)
    solver = solver_builders.get_solver(cfg, device="cpu")
    m = solver.run_step(0, _fake_batch(), {})
    assert np.isfinite(m["ce"].item())


@pytest.mark.parametrize("change, match", [  # ids as before kv_repeat left
    # a dataset source is read now (the datasets are ported): a manifest
    # that does not exist raises; this case named the AudioSeal solver
    # until it was ported
    pytest.param({"datasource": {"train": "train.jsonl"}},
                 "train.jsonl", id="change0-not ported")])
def test_unported_options_raise(change, match):
    cfg = config.load_config("solver/musicgen/debug")
    for key, value in change.items():
        if isinstance(value, dict) and key in cfg:
            cfg[key].update(value)
        else:
            cfg[key] = value
    with pytest.raises(FileNotFoundError, match=match):
        solver_builders.get_solver(cfg, device="cpu")
