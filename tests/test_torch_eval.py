"""The evaluate stage of the port's MusicGen solver with the generative
metrics (`solvers/musicgen.py::evaluate_audio_generation`, the metric
builders of `solvers/builders.py`) against the JAX solver on the CPU.

Both solvers hold the debug LM with the same weights (the JAX package's
init, carried into the port by `jax_weights.load_lm`) and the port's debug
codec (carried into the JAX package by its converter); the JAX solver is
built without its constructor's codec init. The evaluate split is 2
batches of 2 clips of 1 s; generation is greedy (sampled tokens cannot
match across the two packages' generators), 1 s per description.

- Every metric on: FAD over a narrow VGGish from `metrics.fad.vggish.
  model_path`, KLD over a narrow PaSST from `$PASST_CHECKPOINT`, text
  consistency over the tiny CLAP of `tests/test_torch_clap.py` with its
  tokenizer files from `metrics.text_consistency.clap.model_path`, and
  chroma cosine: the same key set as the JAX solver's `evaluate()`, and
  the same values.
- Without VGGish, PaSST or CLAP checkpoints: `fad_logmel`, and no KLD or
  text consistency keys, in both.
- A split whose clips are too short for a VGGish example: `fad` is left
  out by both.

Tolerances: CE and perplexity atol 1e-5 / rtol 1e-5 (as
`tests/test_torch_solvers.py`); FAD and the log-mel FAD rtol 1e-3 (the
square root of a covariance product); the KLD keys, text consistency and
chroma cosine atol 1e-5; the generated tokens equal.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from audiocraft_tpu.data import audio_dataset as jad
from audiocraft_tpu.data import music_dataset as jmusic
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.solvers import musicgen as jmg
from audiocraft_tpu_torch.data import AudioMeta, MusicInfo
from audiocraft_tpu_torch.metrics import passt, vggish
from audiocraft_tpu_torch.solvers import musicgen as tmg
from audiocraft_tpu_torch.utils import jax_weights, safetensors
from tests.test_torch_clap import _bpe_tokenizer_dir, _tiny_model
from tests.test_torch_mbd import _jax_codec, _one_torch_thread  # noqa: F401

SR = 32000
TEXTS = ["warm piano chords", "fast drum and bass", "calm ambient pad",
         "rock guitar riff"]
ALL = {"fad": True, "kld": True, "text_consistency": True,
       "chroma_cosine": True}


def _split(n_frames=SR, cut=0):
    """2 batches of 2 seeded 1 s clips, the second of each `cut` samples
    shorter: (wav, port infos, JAX infos)."""
    rs = np.random.RandomState(3)
    t = np.arange(SR) / SR
    batches = []
    for b in range(2):
        f0 = 110.0 * 2 ** (rs.randint(0, 36, (2, 1, 1)) / 12)
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.02 * rs.randn(2, 1, SR)).astype(np.float32)
        port, jax_infos = [], []
        for i in range(2):
            fields = dict(seek_time=0.0, n_frames=n_frames - cut * i,
                          total_frames=SR, sample_rate=SR, channels=1)
            text = TEXTS[2 * b + i]
            port.append(MusicInfo(meta=AudioMeta("x.wav", 1.0, SR),
                                  description=text, **fields))
            jax_infos.append(jmusic.MusicInfo(
                meta=jad.AudioMeta("x.wav", 1.0, SR), description=text,
                **fields))
        batches.append((wav, port, jax_infos))
    return batches


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_ckpts")
    torch.manual_seed(0)
    model = vggish.VGGish(channels=(4, 8, 8, 8, 16, 16), hidden=(32, 32),
                          embedding=3)
    with torch.no_grad():
        model.embeddings[4].bias.fill_(0.5)    # no unit dead after ReLU
    torch.save(model.state_dict(), d / "vggish.pth")
    torch.manual_seed(1)
    net = passt.PaSST(dim=128, depth=2, mlp_hidden=512, time_patches=16)
    with torch.no_grad():
        for p in (net.cls_token, net.dist_token, net.freq_new_pos_embed,
                  net.time_new_pos_embed):
            p.normal_(0, 0.5)
    torch.save({"net." + k: v for k, v in net.state_dict().items()},
               d / "passt.pt")
    safetensors.save_file(_tiny_model().state_dict(), d / "clap.safetensors")
    _bpe_tokenizer_dir(d)
    return d


@pytest.fixture(scope="module")
def weights():
    jmodel, _ = jbuilders.get_debug_lm_model()
    return jmodel, jlm.init_lm_params(jmodel, jax.random.PRNGKey(7))


def _cfg(folder, asked, ckpts=None, **metrics):
    cfg = {"seed": 0, "sample_rate": SR, "compression_model_checkpoint":
           "debug", "folder": str(folder),
           "dataset": {"segment_duration": 1.0},
           "generate": {"lm": {"use_sampling": False, "gen_duration": 1.0}},
           "evaluate": {"metrics": asked},
           "metrics": {
               "fad": {"model": "vggish", "vggish": {"model_path": None}},
               "kld": {"model": "passt", "passt": {"pretrained_length": 20}},
               "text_consistency": {"model": "clap", "clap": {
                   "model_path": None, "model_arch": "HTSAT-base"}},
               "chroma_cosine": {"model": "chroma_base", "chroma_base": {
                   "sample_rate": SR, "n_chroma": 12, "radix2_exp": 12,
                   "argmax": True}}}}
    if ckpts is not None:
        cfg["metrics"]["fad"]["vggish"]["model_path"] = str(
            ckpts / "vggish.pth")
        cfg["metrics"]["text_consistency"]["clap"]["model_path"] = str(
            ckpts / "clap.safetensors")
    for name, extra in metrics.items():
        cfg["metrics"][name].update(extra)
    return cfg


def _both(tmp_path, weights, cfg, split):
    """The port's solver and the JAX one on the same weights, with the
    evaluate split."""
    port = tmg.MusicGenSolver(cfg, device="cpu")
    jmodel, params = weights
    jax_weights.load_lm(port.model, jax.tree.map(np.asarray, params))
    port.dataloaders["evaluate"] = [(torch.from_numpy(w), infos)
                                    for w, infos, _ in split]
    jsolver = object.__new__(jmg.MusicGenSolver)
    jsolver.cfg = cfg
    jsolver.model, jsolver.state = jmodel, SimpleNamespace(params=params)
    jsolver.compression_model, jsolver.compression_variables = _jax_codec(
        port.compression_model)
    jsolver.dataloaders = {"evaluate": [(w, infos) for w, _, infos in split]}
    return port, jsolver


def _compare(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, value in want.items():
        if key in ("fad", "fad_logmel"):
            np.testing.assert_allclose(got[key], value, rtol=1e-3, err_msg=key)
        elif key in ("ce", "ppl") or key.startswith("ce_q"):
            np.testing.assert_allclose(got[key], value, atol=1e-5, rtol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=1e-5, rtol=0,
                                       err_msg=key)


def _generated(monkeypatch, module):
    """Record the tokens of every generate the solver's model makes."""
    tokens = []
    original = module.MusicGen.generate

    def generate(self, descriptions, *args, **kwargs):
        wav, codes = original(self, descriptions, *args, return_tokens=True,
                              **kwargs)
        tokens.append(np.asarray(codes))
        return wav

    monkeypatch.setattr(module.MusicGen, "generate", generate)
    return tokens


def test_evaluate_with_every_metric_matches_jax(tmp_path, weights,
                                                checkpoints, monkeypatch):
    monkeypatch.setenv("PASST_CHECKPOINT", str(checkpoints / "passt.pt"))
    cfg = _cfg(tmp_path, ALL, checkpoints)
    port, jsolver = _both(tmp_path, weights, cfg, _split())
    from audiocraft_tpu.models import musicgen as jmusicgen
    from audiocraft_tpu_torch.models import musicgen as tmusicgen
    port_tokens = _generated(monkeypatch, tmusicgen)
    jax_tokens = _generated(monkeypatch, jmusicgen)
    got, want = port.evaluate(), jsolver.evaluate()
    assert len(port_tokens) == len(jax_tokens) == 2
    for a, b in zip(port_tokens, jax_tokens):
        np.testing.assert_array_equal(a, b)
    assert {"fad", "kld", "kld_pq", "kld_qp", "kld_both", "text_consistency",
            "chroma_cosine", "ce", "ppl"} <= set(want)
    _compare(got, want)


def test_evaluate_without_checkpoints_matches_jax(tmp_path, weights,
                                                  monkeypatch):
    for var in ("PASST_CHECKPOINT", "VGGISH_CHECKPOINT", "CLAP_CHECKPOINT",
                "AUDIOCRAFT_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    port, jsolver = _both(tmp_path, weights, _cfg(tmp_path, ALL), _split())
    got, want = port.evaluate(), jsolver.evaluate()
    assert "fad_logmel" in want and "chroma_cosine" in want
    assert not {"fad", "kld", "text_consistency"} & set(want)
    _compare(got, want)


def test_a_split_too_short_for_vggish_drops_fad_in_both(tmp_path, weights,
                                                        checkpoints,
                                                        monkeypatch):
    monkeypatch.delenv("PASST_CHECKPOINT", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    cfg = _cfg(tmp_path, {"fad": True, "chroma_cosine": True}, checkpoints,
               chroma_cosine={"use_gt": True})
    port, jsolver = _both(tmp_path, weights, cfg,
                           _split(n_frames=SR // 2, cut=3200))
    got, want = port.evaluate(), jsolver.evaluate()
    assert "fad" not in want and "chroma_cosine" in want
    _compare(got, want)
