"""The port's AudioGen vs the JAX package's on the same weights (the debug
LM over the tiny 16 kHz codec, f32, greedy decoding on the CPU): one
window, and the sliding window past `max_duration`; the AudioGen export
package, the refusal of a waveform condition, and the AudioGen solver.

Tolerance: tokens equal; waveform atol 1e-4 / rtol 1e-3 (f32 codec decode
of equal codes, as `test_torch_musicgen.py`)."""
import jax
import numpy as np
import pytest
import torch

from audiocraft_tpu.models.audiogen import AudioGen as JaxAudioGen
from audiocraft_tpu_torch.config import load_config
from audiocraft_tpu_torch.models import AudioGen, builders
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.solvers import AudioGenSolver, get_solver
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["dog barking in the rain", "siren"]
WAV_TOL = dict(atol=1e-4, rtol=1e-3)
CODEC_CFG = {"compression_model": "encodec", "sample_rate": 16000,
             "channels": 1,
             "seanet": {"dimension": 32, "n_filters": 4,
                        "n_residual_layers": 1, "ratios": [10, 8, 8],
                        "lstm": 0, "norm": "none"},
             "rvq": {"n_q": 4, "bins": 400}}
LM_CFG = {"transformer_lm": {"n_q": 4, "card": 400, "dim": 16, "num_heads": 4,
                             "num_layers": 2, "hidden_scale": 4,
                             "norm_first": False, "bias_proj": True,
                             "causal": True},
          "codebooks_pattern": {"modeling": "delay",
                                "delay": {"delays": [0, 1, 2, 3]}},
          "conditioners": {"description": {"model": "lut", "lut": {
              "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}}},
          "fuser": {"cross": ["description"], "prepend": [], "sum": [],
                    "input_interpolate": []},
          "classifier_free_guidance": {"inference_coef": 3.0},
          "dataset": {"segment_duration": 10}}


@pytest.fixture(scope="module")
def models():
    jag = JaxAudioGen.get_pretrained("debug")
    ag = AudioGen.get_pretrained("debug", device="cpu")
    jax_weights.load_encodec(ag.compression_model,
                             jax.tree.map(np.asarray, jag.compression_variables))
    jax_weights.load_lm(ag.lm, jax.tree.map(np.asarray, jag.lm_params))
    return jag, ag


@pytest.mark.parametrize("duration,frames", [(0.5, 12), (10.5, 262)])
def test_debug_audiogen_matches_jax(models, duration, frames):
    """One window, then past the 10 s window (it moves by 2 s)."""
    jag, ag = models
    for model in models:
        model.set_generation_params(duration=duration, use_sampling=False)
    jw, jt = jag.generate(TEXTS, return_tokens=True)
    pw, pt = ag.generate(TEXTS, return_tokens=True)
    assert tuple(pt.shape) == (2, 4, frames)
    assert tuple(pw.shape) == (2, 1, frames * 640)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **WAV_TOL)


def test_audiogen_defaults(models):
    _, ag = models
    fresh = AudioGen("debug", ag.compression_model, ag.lm, device="cpu")
    assert fresh.sample_rate == 16000 and fresh.frame_rate == 25
    assert fresh.duration == 10 and fresh.extend_stride == 2
    assert fresh.generation_params["cfg_coef"] == 3.0
    assert fresh.generation_params["top_k"] == 250
    with pytest.raises(AssertionError):
        fresh.set_generation_params(extend_stride=10)


def test_audiogen_two_step_cfg_matches_batched(models):
    """Cross-attention conditioning: the two modes agree (ROADMAP §3)."""
    _, ag = models
    ag.set_generation_params(duration=0.5, use_sampling=False)
    _, batched = ag.generate(TEXTS, return_tokens=True)
    ag.set_generation_params(duration=0.5, use_sampling=False,
                             two_step_cfg=True)
    _, two_step = ag.generate(TEXTS, return_tokens=True)
    assert torch.equal(batched, two_step)


def test_audiogen_package_loads_and_refuses_a_melody(tmp_path):
    lm = builders.get_lm_model(LM_CFG, device="cpu", seed=3)
    codec = builders.get_debug_compression_model(device="cpu", seed=4,
                                                 sample_rate=16000)
    torch.save({"best_state": lm.state_dict(), "xp.cfg": LM_CFG},
               tmp_path / "state_dict.bin")
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    ag = AudioGen.get_pretrained(str(tmp_path), device="cpu")
    assert ag.sample_rate == 16000 and ag.max_duration == 10
    for key, value in lm.state_dict().items():
        assert torch.equal(ag.lm.state_dict()[key], value), key
    melody_dir = tmp_path / "melody"
    melody_dir.mkdir()
    melody = builders.get_debug_melody_lm_model(device="cpu")
    cfg = dict(LM_CFG, conditioners=dict(
        LM_CFG["conditioners"], self_wav={"model": "chroma_stem", "chroma_stem": {
            "sample_rate": 32000, "radix2_exp": 10, "duration": 1.0}}),
        fuser=dict(LM_CFG["fuser"], prepend=["self_wav"]))
    torch.save({"best_state": melody.state_dict(), "xp.cfg": cfg},
               melody_dir / "state_dict.bin")
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               melody_dir / "compression_state_dict.bin")
    with pytest.raises(AssertionError, match="waveform"):
        AudioGen.get_pretrained(str(melody_dir), device="cpu")


def test_audiogen_solver_takes_a_step():
    cfg = load_config("solver/audiogen/debug")
    solver = get_solver(cfg, device="cpu")
    assert isinstance(solver, AudioGenSolver) and solver.DATASET_TYPE == "sound"
    assert solver.compression_model.sample_rate == 16000
    codes = torch.from_numpy(np.random.RandomState(0).randint(0, 400, (2, 4, 50)))
    tokenized = solver.model.condition_provider.tokenize(
        [ConditioningAttributes(text={"description": t}) for t in TEXTS])
    batch = {"codes": codes, "tokenized": tokenized,
             "padding_mask": torch.ones(2, 50, dtype=torch.bool)}
    metrics = solver.run_step(0, batch, {})
    assert np.isfinite(float(metrics["ce"]))
