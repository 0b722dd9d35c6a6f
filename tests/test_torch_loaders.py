"""Local checkpoint loading of the port (`models/loaders.py`,
`MusicGen.get_pretrained`) vs the JAX package's loaders on the same files:
a seeded debug port model is saved as audiocraft export packages
(`state_dict.bin`, `compression_state_dict.bin`) in a temporary directory
and loaded by both packages; names with no local files raise.

Tolerance: tokens equal (greedy, f32); waveform atol 1e-4 / rtol 1e-3 (f32
codec decode of equal codes, as in `test_torch_musicgen.py`)."""
import numpy as np
import pytest
import torch
import yaml

from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu.models import loaders as jax_loaders
from audiocraft_tpu_torch.models import MusicGen, builders, loaders

TEXTS = ["90s rock song with loud guitars", "calm piano"]
CODEC_CFG = {"compression_model": "encodec", "sample_rate": 32000,
             "channels": 1,
             "seanet": {"dimension": 32, "n_filters": 4,
                        "n_residual_layers": 1, "ratios": [10, 8, 16],
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
          "dataset": {"segment_duration": 30}}


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """The seeded debug port model as a directory of export packages."""
    root = tmp_path_factory.mktemp("musicgen-debug-export")
    codec = builders.get_debug_compression_model(device="cpu", seed=3)
    lm = builders.get_debug_lm_model(device="cpu", seed=4)
    lm.reset_parameters(4)
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               root / "compression_state_dict.bin")
    torch.save({"best_state": lm.state_dict(), "xp.cfg": LM_CFG},
               root / "state_dict.bin")
    return root, codec, lm


def test_packages_load_into_the_port_unchanged(package):
    root, codec, lm = package
    mg = MusicGen.get_pretrained(str(root), device="cpu")
    for got, want in ((mg.compression_model, codec), (mg.lm, lm)):
        state = got.state_dict()
        assert state.keys() == want.state_dict().keys()
        for key, value in want.state_dict().items():
            assert torch.equal(state[key], value), key
    assert mg.max_duration == 30 and mg.lm.cfg_coef == 3.0


def test_both_packages_give_the_same_greedy_generation(package):
    root, _, _ = package
    jmg = JaxMusicGen.get_pretrained(str(root))
    jmg.set_generation_params(use_sampling=False, duration=0.5)
    jwav, jtok = jmg.generate(TEXTS, return_tokens=True)
    mg = MusicGen.get_pretrained(str(root), device="cpu")
    mg.set_generation_params(use_sampling=False, duration=0.5)
    wav, tok = mg.generate(TEXTS, return_tokens=True)
    assert tok.shape == (2, 4, 12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=1e-4,
                               rtol=1e-3)


def test_names_resolve_under_the_cache_dir(package, monkeypatch, tmp_path):
    """A short name maps to its upstream name, looked up under
    AUDIOCRAFT_CACHE_DIR."""
    root, _, lm = package
    target = tmp_path / "facebook" / "musicgen-small"
    target.parent.mkdir()
    target.symlink_to(root)
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path))
    mg = MusicGen.get_pretrained("small", device="cpu")
    assert mg.name == "facebook/musicgen-small"
    assert torch.equal(mg.lm.emb[0].weight, lm.emb[0].weight)


@pytest.mark.parametrize("name", ["small", "no/such/checkpoint"])
def test_a_name_without_local_files_raises_as_in_jax(name, monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as port_error:
        MusicGen.get_pretrained(name, device="cpu")
    with pytest.raises(FileNotFoundError) as jax_error:
        jax_loaders.load_lm_model(
            {"small": "facebook/musicgen-small"}.get(name, name))
    assert str(port_error.value) == str(jax_error.value)


def test_yaml_config_with_references_loads(package, tmp_path):
    """An export whose `xp.cfg` is YAML text with `${...}` references (as
    audiocraft writes it) gives the same LM."""
    root, _, lm = package
    cfg = dict(LM_CFG, dim=16)
    cfg["transformer_lm"] = dict(LM_CFG["transformer_lm"], dim="${dim}")
    torch.save({"best_state": lm.state_dict(), "xp.cfg": yaml.safe_dump(cfg)},
               tmp_path / "state_dict.bin")
    loaded, got_cfg = loaders.load_lm_model(str(tmp_path), device="cpu")
    assert got_cfg["transformer_lm"]["dim"] == 16
    assert torch.equal(loaded.linears[0].weight, lm.linears[0].weight)
