"""The port's training run loop on the CPU, held against the JAX package
where the JAX package has the same function: the EMA of weights, checkpoint
save / restore / resume, the warm start from a checkpoint that the JAX
package wrote, `run()` over epochs, `evaluate`, the writers, the profiler,
the deadlock watchdog, and `StandardSolver`.

Tolerances: the EMA atol 1e-7 (f32, the same operations); a checkpoint
round trip and a resumed run are bitwise on the CPU (the same operations in
the same order); CE and perplexity of `evaluate` atol 1e-5 / rtol 1e-5 (f32
sums in another order)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.optim import ema as jema
from audiocraft_tpu.solvers import musicgen as jmg
from audiocraft_tpu.utils import checkpoint as jckpt
from audiocraft_tpu_torch.data import AudioInfo, AudioMeta, MusicInfo
from audiocraft_tpu_torch.modules import conditioners as tcond
from audiocraft_tpu_torch.optim import ema as tema
from audiocraft_tpu_torch.solvers import StandardSolver
from audiocraft_tpu_torch.solvers import musicgen as tmg
from audiocraft_tpu_torch.utils import checkpoint as tckpt
from audiocraft_tpu_torch.utils import deadlock, profiler, writers
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["warm analog synth arpeggio", "fast drum and bass"]


def _batch(seed=0, B=2, T=12800, sr=32000):
    rs = np.random.RandomState(seed)
    wav = (0.1 * rs.randn(B, 1, T)).astype(np.float32)
    infos = [MusicInfo(**AudioInfo(AudioMeta("x.wav", T / sr, sr), 0.0,
                                   T - 2560 * i, T, sr, 1).to_dict(),
                       description=TEXTS[i % 2]) for i in range(B)]
    return wav, infos


def _cfg(folder, epochs=1, **extra):
    cfg = {"seed": 0, "sample_rate": 32000,
           "compression_model_checkpoint": "debug", "folder": str(folder),
           "classifier_free_guidance": {"training_dropout": 0.5},
           "attribute_dropout": {"text": {"description": 0.3}},
           "optim": {"epochs": epochs, "updates_per_epoch": 1,
                     "optimizer": "adamw", "lr": 1e-3,
                     "adam": {"betas": [0.9, 0.95], "weight_decay": 0.1}}}
    cfg.update(extra)
    return cfg


def _solver(cfg, batches):
    solver = tmg.MusicGenSolver(cfg, device="cpu")
    solver.dataloaders["train"] = batches
    return solver


# ---------------------------------------------------------------------- EMA

def test_ema_matches_jax():
    rs = np.random.RandomState(0)
    steps = [{"w": rs.randn(3, 2).astype(np.float32),
              "b": rs.randn(4).astype(np.float32),
              "n": np.array(i, np.int64)} for i in range(5)]
    decay = 0.9
    jstate = jema.ema_init({k: jnp.asarray(v) for k, v in steps[0].items()})
    tstate = tema.ema_init({k: torch.from_numpy(v) for k, v in steps[0].items()})
    for named in steps:
        jstate = jema.ema_update(jstate, {k: jnp.asarray(v)
                                          for k, v in named.items()}, decay)
        tema.ema_update(tstate, {k: torch.from_numpy(v)
                                 for k, v in named.items()}, decay)
        want = jema.ema_params(jstate, decay)
        got = tema.ema_params(tstate, decay)
        for key in named:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=1e-7, rtol=0, err_msg=key)
    assert float(tstate.count) == float(jstate.count) == 5
    assert int(got["n"]) == 4


# -------------------------------------------------------------- checkpoints

def test_checkpoint_names_sources_and_stale_flush(tmp_path, monkeypatch):
    assert tckpt.checkpoint_name() == jckpt.checkpoint_name(rank=0) == \
        "checkpoint.th"
    for args in [("best", 0, False), (None, 2, False), (None, 0, True)]:
        assert tckpt.checkpoint_name(*args) == jckpt.checkpoint_name(*args)
    assert tckpt.is_sharded_checkpoint(tmp_path / "checkpoint.th.3")
    assert not tckpt.is_sharded_checkpoint(tmp_path / "checkpoint.th")
    monkeypatch.setenv("AUDIOCRAFT_DORA_DIR", str(tmp_path))
    xp = tmp_path / "xps" / "abc"
    xp.mkdir(parents=True)
    assert tckpt.resolve_checkpoint_path("//sig/abc") is None
    (xp / "checkpoint.th").write_bytes(b"x")
    assert tckpt.resolve_checkpoint_path("//sig/abc") == xp / "checkpoint.th"
    assert tckpt.resolve_checkpoint_path(xp) == xp / "checkpoint.th"
    for epoch in (1, 2, 10, 3):
        (xp / f"checkpoint_{epoch}.th").write_bytes(b"x")
    tckpt.flush_stale_checkpoints(xp / "checkpoint.th", keep_last=2)
    assert sorted(p.name for p in xp.glob("checkpoint_*.th")) == [
        "checkpoint_10.th", "checkpoint_3.th"]


def test_save_restore_round_trip_is_bitwise(tmp_path):
    a = _solver(_cfg(tmp_path), [_batch(0), _batch(1)])
    a.run_one_stage("train")
    a.run_step(1, _batch(1), {})
    a.save_checkpoints()
    assert not list(tmp_path.glob("*.tmp"))
    b = _solver(_cfg(tmp_path), [])
    assert b.restore() and b.epoch == 1
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.state_dict(), b.state_dict()
    for p, state in sa["optimizer"]["state"].items():
        for key, value in state.items():
            assert torch.equal(value, sb["optimizer"]["state"][p][key])
    assert sb["step"] == sa["step"] == 2
    assert torch.equal(sa["rng"]["dropout"], sb["rng"]["dropout"])
    assert a.cfg_dropout.rng.rand() == b.cfg_dropout.rng.rand()


def test_resume_takes_the_next_step_of_the_uninterrupted_run(tmp_path):
    """Three epochs of one step straight through, against two epochs, a
    new solver that restores them and runs the third: the same CE and the
    same weights, bit for bit (condition dropouts and dropout seeds
    included)."""
    batches = [_batch(3)]
    whole = _solver(_cfg(tmp_path / "whole", epochs=3), batches)
    history = whole.run()
    assert [sorted(h) for h in history] == [["train"], ["train"], [
        "evaluate", "generate", "train"]]  # the last epoch's stages
    first = _solver(_cfg(tmp_path / "cut", epochs=2), batches)
    first.run()
    resumed = _solver(_cfg(tmp_path / "cut", epochs=3), batches)
    rest = resumed.run()
    assert len(rest) == 1 and resumed.epoch == 4
    assert rest[0]["train"]["ce"] == history[2]["train"]["ce"]
    for (name, x), y in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(x, y), name
    sidecar = json.loads((tmp_path / "cut" / "checkpoint.th.json").read_text())
    assert sidecar["epoch"] == 3 and len(sidecar["history"]) == 3


@pytest.fixture(scope="module")
def jax_debug():
    jmodel, params = jbuilders.get_debug_lm_model()
    params = jlm.init_lm_params(jmodel, jax.random.PRNGKey(7))
    return jmodel, params


def _eval_batches(card, n=2):
    rs = np.random.RandomState(11)
    batches = []
    for _ in range(n):
        codes = rs.randint(0, card, (2, 4, 10))
        codes[1, :, -2:] = card
        batches.append(codes)
    return batches


def _jax_eval(jmodel, params, batches):
    tokenized = jlm.tokenize_conditions(
        jmodel, [jcond.ConditioningAttributes(text={"description": t})
                 for t in TEXTS])
    step = jmg.make_eval_step(jmodel)
    ces = [float(step(params, jnp.asarray(c), tokenized, None)["ce"])
           for c in batches]
    return float(np.mean(ces)), float(np.mean(np.exp(ces)))


def _port_eval_loader(solver, batches):
    tokenized = solver.model.condition_provider.tokenize(
        [tcond.ConditioningAttributes(text={"description": t}) for t in TEXTS])
    return [{"codes": torch.from_numpy(c), "tokenized": tokenized}
            for c in batches]


def test_warm_start_from_a_jax_checkpoint_gives_the_jax_ce(tmp_path,
                                                           jax_debug):
    """A training state saved by the JAX package's `save_checkpoint` (npz)
    given as `continue_from`: its parameters only, epoch 0; then the CE of
    `evaluate` is the JAX eval step's at those parameters."""
    jmodel, params = jax_debug
    opt = jmg.make_optimizer(1e-3)
    path = tmp_path / "jax" / "checkpoint.th"
    path.parent.mkdir()
    jckpt.save_checkpoint(jmg.init_train_state(jmodel, params, opt), path)
    assert tckpt.is_jax_checkpoint(path)
    solver = _solver(_cfg(tmp_path / "xp"), [])
    assert solver.restore(continue_from=str(path.parent))
    assert solver.epoch == 0
    batches = _eval_batches(jmodel.card)
    solver.dataloaders["evaluate"] = _port_eval_loader(solver, batches)
    got = solver.evaluate()
    ce, _ = _jax_eval(jmodel, params, batches)
    np.testing.assert_allclose(got["ce"], ce, atol=1e-5, rtol=1e-5)


def test_evaluate_gives_the_jax_ce_and_perplexity(tmp_path, jax_debug):
    jmodel, params = jax_debug
    solver = _solver(_cfg(tmp_path), [])
    jax_weights.load_lm(solver.model, jax.tree.map(np.asarray, params))
    batches = _eval_batches(jmodel.card)
    solver.dataloaders["evaluate"] = _port_eval_loader(solver, batches)
    got = solver.run_one_stage("evaluate")
    ce, ppl = _jax_eval(jmodel, params, batches)
    assert set(got) == {"ce", "ppl", "ce_q1", "ce_q2", "ce_q3", "ce_q4"}
    np.testing.assert_allclose(got["ce"], ce, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], ppl, atol=1e-5, rtol=1e-5)


def test_run_two_epochs_writes_metrics_and_checkpoints(tmp_path):
    """`run()` with evaluate and generate every epoch and no loader for
    either: both give {}; the valid stage evaluates without an update."""
    cfg = _cfg(tmp_path, epochs=2, evaluate={"every": 1},
               generate={"every": 1}, logging={"log_tensorboard": True,
                                               "log_updates": 1})
    solver = _solver(cfg, [_batch(0)])
    history = solver.run()
    assert len(history) == 2 and solver.epoch == 3
    assert all(h["evaluate"] == {} and h["generate"] == {} for h in history)
    assert np.isfinite(history[1]["train"]["ce"])
    assert list((tmp_path / "tensorboard").glob("events.out.tfevents.*"))
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    solver.dataloaders["valid"] = [_batch(1)]
    valid = solver.run_one_stage("valid")
    assert "grad_norm" not in valid and np.isfinite(valid["ce"])
    assert all(torch.equal(before[k], v)
               for k, v in solver.model.state_dict().items())
    solver.cfg["execute_only"] = "evaluate"
    assert solver.run() == [{"evaluate": {}}]


def test_unported_stages_raise_naming_slice_h(tmp_path):
    """The stages slice H ported: the generative metrics no longer raise
    (without an 'evaluate' loader they give {}; `tests/test_torch_eval.py`
    holds them against the JAX solver), and the generate stage stores its
    samples."""
    solver = _solver(_cfg(tmp_path, evaluate={"metrics": {"fad": True}}), [])
    assert solver.evaluate_audio_generation() == {}
    # the generate stage stores its samples through the sample manager
    solver.dataloaders["generate"] = [_batch(0)]
    solver.cfg["generate"] = {"lm": {"gen_duration": 0.2,
                                     "use_sampling": False}}
    assert solver.run_one_stage("generate") == {"generated_samples": 2}
    assert len(list((tmp_path / "samples" / "1").glob("*.json"))) == 2


# --------------------------------------------------------- host-side tools

def test_writers_wav_bytes_and_a_missing_backend(tmp_path, monkeypatch):
    import io
    import wave
    wav = np.stack([np.linspace(-1, 1, 50), np.zeros(50)]).astype(np.float32)
    with wave.open(io.BytesIO(writers.wav_bytes(wav, 16000))) as f:
        assert (f.getnchannels(), f.getframerate(), f.getnframes(),
                f.getsampwidth()) == (2, 16000, 50, 2)
        frames = np.frombuffer(f.readframes(50), "<i2").reshape(50, 2)
    assert frames[0, 0] == -32768 and frames[-1, 0] == 32767
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    with pytest.warns(UserWarning, match="wandb is not installed"):
        w = writers.ExperimentWriters({"logging": {"log_wandb": True}},
                                      tmp_path)
    assert not w.active
    w.write_scalars("train", {"ce": 1.0}, 1)


def test_profiler_traces_the_first_steps(tmp_path):
    prof = profiler.Profiler(enabled=True, output_dir=tmp_path, num_steps=2)
    with prof:
        for _ in range(3):
            torch.ones(4).sum()
            prof.step()
    with prof:  # past num_steps: nothing more
        prof.step()
    assert [p.name for p in tmp_path.iterdir()] == ["trace_2.json"]


def test_deadlock_watchdog_fires_only_without_progress(monkeypatch):
    import time
    fired = []
    monkeypatch.setattr(deadlock.DeadlockDetect, "_kill",
                        lambda self: fired.append(self.last_stage))
    watch = deadlock.DeadlockDetect(use=True, timeout=0.2)
    with watch:
        for i in range(6):
            watch.update(f"step {i}")
            time.sleep(0.05)
    assert fired == []
    with watch:
        watch.update("stuck")
        time.sleep(0.6)
    assert fired == ["stuck"]
    with deadlock.DeadlockDetect(use=False, timeout=0.01) as off:
        off.update("x")
        time.sleep(0.05)
    assert fired == ["stuck"]


# ----------------------------------------------------------- StandardSolver

class _Regression(StandardSolver):
    """y = x w on fixed data, SGD; the smallest StandardSolver."""

    def build_dataloaders(self):
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(4, 8, 3).astype(np.float32))
        y = x @ torch.tensor([1.0, -2.0, 0.5])
        self.dataloaders = {"train": list(zip(x, y)), "valid": [(x[0], y[0])]}

    def build_model(self):
        torch.manual_seed(0)
        self.model = nn.Linear(3, 1, bias=False)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.1)

    @property
    def best_metric_name(self):
        return "loss"

    def run_step(self, idx, batch, metrics):
        x, y = batch
        loss = (self.model(x)[:, 0] - y).square().mean()
        if self.current_stage == "train":
            self.optimizer.zero_grad()
            loss.backward()
            self.optimizer.step()
        return {"loss": loss.detach()}


def test_standard_solver_ema_best_state_and_resume(tmp_path):
    cfg = {"folder": str(tmp_path), "optim": {
        "epochs": 2, "ema": {"use": True, "decay": 0.5, "updates": 1}}}
    solver = _Regression(cfg, device="cpu")
    weights = []
    original = solver._step_done

    def record(split, idx):
        if split == "train":
            weights.append(solver.model.weight.detach().clone())
        original(split, idx)
    solver._step_done = record
    history = solver.run()
    assert [sorted(h) for h in history] == [
        ["train", "valid"], ["evaluate", "generate", "train", "valid"]]
    jstate = jema.ema_init({"weight": jnp.zeros((1, 3))})
    for w in weights:
        jstate = jema.ema_update(jstate, {"weight": jnp.asarray(w.numpy())},
                                 0.5)
    want = np.asarray(jema.ema_params(jstate, 0.5)["weight"])
    np.testing.assert_allclose(
        tema.ema_params(solver.ema_state, 0.5)["weight"].numpy(), want,
        atol=1e-7)
    np.testing.assert_allclose(solver.best_state["weight"].numpy(), want,
                               atol=1e-7)
    # the model keeps its own weights outside the swap
    assert torch.equal(solver.model.weight.detach(), weights[-1])
    resumed = _Regression(cfg, device="cpu")
    resumed.init_ema()
    assert resumed.restore() and resumed.epoch == 2
    assert torch.equal(resumed.model.weight, solver.model.weight)
    assert torch.equal(resumed.ema_state.shadow["weight"],
                       solver.ema_state.shadow["weight"])
    assert resumed._best_metric_value == solver._best_metric_value
