"""The port's evaluation metrics (`audiocraft_tpu_torch/metrics/`) against
the JAX package on the CPU, on the same seeded inputs and weights:

- VGGish: `waveform_to_examples` at 32 and 16 kHz; the network read by
  both packages from one torchvggish-layout `.pth` and one `.npz` (narrow
  widths: convolutions of 4-16 channels, fully connected 32-32-8);
- PaSST: `passt_mel`; the network from one hear21passt-layout `.pt`, bare
  and `net.`-prefixed (d 128, 2 heads, 2 blocks, 16 time positions), and
  its assertion on an input longer than its time positions;
  `PasstClassifier` on an input shorter than 0.15 s, one longer than its
  time positions (segmented) and one at 16 kHz;
- `frechet_distance` on rank-deficient covariances (the eps retry) and on
  full-rank ones, `logmel_embeddings`;
- each metric's `compute` against the JAX metric on the same waveforms and
  sizes: FAD over VGGish and over the log-mel fallback, KLD over PaSST,
  CLAP text consistency over the tiny CLAP of `tests/test_torch_clap.py`,
  chroma cosine; PESQ with a `pesq` module injected into both packages,
  and its gate without one; ViSQOL with a stand-in `bazel-bin/visqol`.

Tolerances: examples and mels atol 1e-4 (log of an f32 spectrum; the two
packages' resamplers differ by about 1e-6); passt_mel atol 1e-5; the
networks atol 1e-4 (f32); PaSST probabilities atol 1e-5; FAD rtol 1e-3
(the square root of a covariance product); the KLD keys, text consistency
and chroma cosine atol 1e-5; frechet_distance rtol 1e-9 (the same float64
numpy and scipy code); PESQ atol 1e-5; the ViSQOL wav files within one
16-bit step and its mean atol 1e-4.
"""
import csv
import sys
import types
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.metrics import chroma_cosinesim as jchroma
from audiocraft_tpu.metrics import clap_consistency as jclapc
from audiocraft_tpu.metrics import fad as jfad
from audiocraft_tpu.metrics import kld as jkld
from audiocraft_tpu.metrics import passt as jpasst
from audiocraft_tpu.metrics import pesq as jpesq
from audiocraft_tpu.metrics import vggish as jvggish
from audiocraft_tpu.metrics import visqol as jvisqol
from audiocraft_tpu_torch import metrics
from audiocraft_tpu_torch.metrics import fad, passt, pesq, vggish, visqol
from audiocraft_tpu_torch.utils import safetensors
from tests.test_torch_clap import _bpe_tokenizer_dir, _tiny_model
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

VGGISH_NARROW = dict(channels=(4, 8, 8, 8, 16, 16), hidden=(32, 32),
                     embedding=8)
PASST_NARROW = dict(dim=128, depth=2, mlp_hidden=512, time_patches=16)
TEXTS = ["warm piano", "fast drums and 2 guitars"]


def _music(seed, B, seconds, sr=32000, C=1):
    """Seeded harmonic tones with a little noise, [B, C, T] f32."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110.0 * 2 ** (rs.randint(0, 36, (B, C, 1)) / 12)
    wav = sum(rs.rand(B, C, 1) / h * np.sin(2 * np.pi * h * f0 * t)
              for h in range(1, 4))
    wav = wav + 0.05 * rs.randn(B, C, len(t))
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


@pytest.fixture(scope="module")
def vggish_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("vggish")
    torch.manual_seed(0)
    model = vggish.VGGish(**VGGISH_NARROW).eval()
    state = model.state_dict()
    torch.save(state, d / "vggish.pth")
    np.savez(d / "vggish.npz", **{k: v.numpy() for k, v in state.items()})
    return model, d


@pytest.fixture(scope="module")
def passt_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("passt")
    torch.manual_seed(1)
    model = passt.PaSST(**PASST_NARROW).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1 and p.shape[0] == 128 and p.abs().sum() == 0:
                p.normal_(0, 0.02)          # biases and the zero tokens
        model.cls_token.normal_(0, 0.5)
        model.dist_token.normal_(0, 0.5)
        model.freq_new_pos_embed.normal_(0, 0.5)
        model.time_new_pos_embed.normal_(0, 0.5)
    state = model.state_dict()
    torch.save(state, d / "passt.pt")
    torch.save({"net." + k: v for k, v in state.items()}, d / "net.pt")
    return model, d


@pytest.fixture(scope="module")
def clap_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("clap")
    safetensors.save_file(_tiny_model().state_dict(), d / "clap.safetensors")
    _bpe_tokenizer_dir(d)
    return d / "clap.safetensors"


# ------------------------------------------------------------------ VGGish
@pytest.mark.parametrize("sr", [32000, 16000])
def test_waveform_to_examples_matches_jax(sr):
    wav = _music(0, 1, 2.5, sr, C=2)[0]
    got = vggish.waveform_to_examples(wav, sr)
    want = jvggish.waveform_to_examples(wav, sr)
    assert got.shape == want.shape == (2, 96, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert vggish.waveform_to_examples(np.zeros(100, np.float32),
                                       16000).shape == (0, 96, 64)


@pytest.mark.parametrize("suffix", ["pth", "npz"])
def test_vggish_network_matches_jax(vggish_ckpt, suffix):
    model, d = vggish_ckpt
    path = d / f"vggish.{suffix}"
    port = vggish.VGGish.from_state_dict(vggish.load_vggish_params(path),
                                         "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    examples = np.random.RandomState(2).randn(3, 96, 64).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(examples)).numpy()
    want = np.asarray(jvggish.vggish_apply(jvggish.load_vggish_params(path),
                                           jnp.asarray(examples)))
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vggish_embedder_matches_jax(vggish_ckpt):
    _, d = vggish_ckpt
    wav = _music(3, 2, 2.2)
    got = vggish.VGGishEmbedder(vggish.load_vggish_params(d / "vggish.pth"),
                                batch_size=1, device="cpu")(wav, 32000)
    want = jvggish.VGGishEmbedder(jvggish.load_vggish_params(
        d / "vggish.pth"))(wav, 32000)
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------------------- PaSST
def test_passt_mel_matches_jax():
    wav = _music(4, 1, 1.3)[0, 0]
    np.testing.assert_allclose(passt.passt_mel(wav), jpasst.passt_mel(wav),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["passt.pt", "net.pt"])
def test_passt_network_matches_jax(passt_ckpt, name):
    model, d = passt_ckpt
    port = passt.PaSST.from_state_dict(passt.load_passt_params(d / name),
                                       "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    mel = np.random.RandomState(5).randn(2, 128, 96).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    want = np.asarray(jpasst.passt_apply(jpasst.load_passt_params(d / name),
                                         jnp.asarray(mel)))
    assert got.shape == (2, 527)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with pytest.raises(AssertionError, match="time positions"):
        port(torch.zeros(1, 128, 10 * 16 + 16))


@pytest.mark.parametrize("seconds, sr", [(0.1, 32000), (3.9, 32000),
                                         (1.2, 16000)])
def test_passt_classifier_matches_jax(passt_ckpt, seconds, sr):
    _, d = passt_ckpt
    wav = _music(6, 2, seconds, sr, C=2)
    port = passt.PasstClassifier(passt.load_passt_params(d / "passt.pt"),
                                 device="cpu")
    jax_cls = jpasst.PasstClassifier(jpasst.load_passt_params(d / "passt.pt"))
    assert port.max_frames == jax_cls.max_frames == (10 * 16 + 14) * 320 + 1
    got, want = port(wav, sr), jax_cls(wav, sr)
    assert got.shape == (2, 527)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------- FAD
@pytest.mark.parametrize("n", [3, 40])
def test_frechet_distance_matches_jax(n):
    rs = np.random.RandomState(n)
    x, y = rs.randn(n, 16), rs.randn(n, 16) + 0.5
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0),
            np.cov(y, rowvar=False))
    got = fad.frechet_distance(*args)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, jfad.frechet_distance(*args), rtol=1e-9)


def test_logmel_embeddings_match_jax():
    wav = _music(7, 2, 2.1)
    got = fad.logmel_embeddings(wav, 32000)
    want = jfad.logmel_embeddings(wav, 32000)
    assert got.shape == want.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _update_both(port, jax_metric, *args):
    port.update(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                  and a.dtype == np.float32 else a for a in args))
    jax_metric.update(*args)


@pytest.mark.parametrize("kind", ["vggish", "logmel-fallback"])
def test_fad_matches_jax(vggish_ckpt, monkeypatch, kind):
    _, d = vggish_ckpt
    monkeypatch.delenv("VGGISH_CHECKPOINT", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    path = str(d / "vggish.pth") if kind == "vggish" else None
    port = metrics.FrechetAudioDistanceMetric(model_path=path, device="cpu")
    jax_metric = jfad.FrechetAudioDistanceMetric(model_path=path)
    assert port.embed_kind == jax_metric.embed_kind == kind
    preds, targets = _music(8, 4, 3.1), _music(9, 4, 3.1)
    sizes = np.array([99200, 96000, 99200, 64000])   # a cut item
    _update_both(port, jax_metric, preds, targets, sizes,
                 np.full(4, 32000))
    got, want = port.compute(), jax_metric.compute()
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


# ------------------------------------------------------------------- KLD
def test_kld_matches_jax(passt_ckpt, monkeypatch):
    _, d = passt_ckpt
    monkeypatch.setenv("PASST_CHECKPOINT", str(d / "net.pt"))
    port = metrics.PasstKLDivergenceMetric(pretrained_length=20,
                                           device="cpu")
    jax_metric = jkld.PasstKLDivergenceMetric(pretrained_length=20)
    preds, targets = _music(10, 3, 1.0), _music(11, 3, 1.0)
    sizes = np.array([32000, 20000, 4000])
    _update_both(port, jax_metric, preds, targets, sizes, np.full(3, 32000))
    got, want = port.compute(), jax_metric.compute()
    assert set(got) == set(want) == {"kld", "kld_pq", "kld_qp", "kld_both"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    monkeypatch.delenv("PASST_CHECKPOINT")
    assert metrics.PasstKLDivergenceMetric(device="cpu").classifier_fn is None


# ------------------------------------------------------ text consistency
def test_text_consistency_matches_jax(clap_ckpt, monkeypatch):
    monkeypatch.delenv("CLAP_CHECKPOINT", raising=False)
    port = metrics.CLAPTextConsistencyMetric(model_path=str(clap_ckpt),
                                             model_arch="HTSAT-base",
                                             device="cpu")
    jax_metric = jclapc.CLAPTextConsistencyMetric(model_path=str(clap_ckpt))
    assert port.embed_audio_fn is not None
    audio = _music(12, 2, 1.0)
    _update_both(port, jax_metric, audio, TEXTS, np.array([32000, 32000]),
                 np.full(2, 32000))
    np.testing.assert_allclose(port.compute(), jax_metric.compute(),
                               atol=1e-5, rtol=0)
    # without tokenizer files both packages report it unavailable
    bare = clap_ckpt.parent / "bare"
    bare.mkdir(exist_ok=True)
    (bare / "clap.safetensors").write_bytes(clap_ckpt.read_bytes())
    monkeypatch.delenv("CLAP_TOKENIZER", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    assert metrics.CLAPTextConsistencyMetric(
        model_path=str(bare / "clap.safetensors"),
        device="cpu").embed_audio_fn is None
    assert jclapc.CLAPTextConsistencyMetric(
        model_path=str(bare / "clap.safetensors")).embed_audio_fn is None
    with pytest.raises(AssertionError, match="fusion"):
        metrics.CLAPTextConsistencyMetric(enable_fusion=True, device="cpu")


# --------------------------------------------------------- chroma cosine
def test_chroma_cosine_matches_jax():
    args = dict(sample_rate=32000, n_chroma=12, radix2_exp=12, argmax=True)
    port = metrics.ChromaCosineSimilarityMetric(**args, device="cpu")
    jax_metric = jchroma.ChromaCosineSimilarityMetric(**args)
    for seed in (13, 14):
        preds, targets = _music(seed, 2, 1.5, C=2), _music(seed + 10, 2, 1.5,
                                                            C=2)
        _update_both(port, jax_metric, preds, targets,
                     np.array([48000, 30000]), np.full(2, 32000))
    assert port.weight == jax_metric.weight
    np.testing.assert_allclose(port.compute(), jax_metric.compute(),
                               atol=1e-5, rtol=0)


# -------------------------------------------------------------------- PESQ
def test_pesq_with_an_injected_module_matches_jax(monkeypatch):
    def fake(rate, ref, deg):
        assert rate == 16000
        if not np.any(deg):
            raise ValueError("silent signal")
        return float(np.round(1 + np.abs(ref - deg).mean() * 10, 6))

    module = types.SimpleNamespace(pesq=fake)
    for mod in (pesq, jpesq):
        monkeypatch.setattr(mod, "_HAS_PESQ", True)
        monkeypatch.setattr(mod, "pesq_lib", module)
    preds, targets = _music(15, 3, 0.5), _music(16, 3, 0.5)
    preds[2] = 0.0                      # refused, so not counted
    port, jax_metric = metrics.PesqMetric(32000), jpesq.PesqMetric(32000)
    port.update(torch.from_numpy(preds), torch.from_numpy(targets))
    jax_metric.update(preds, targets)
    assert port.weight == jax_metric.weight == 2
    np.testing.assert_allclose(port.compute(), jax_metric.compute(),
                               atol=1e-5, rtol=0)


def test_pesq_gate_without_the_module(monkeypatch):
    monkeypatch.setattr(pesq, "_HAS_PESQ", False)
    metric = metrics.PesqMetric(16000)
    with pytest.raises(RuntimeError, match="pesq"):
        metric.update(np.zeros((1, 1, 1600), np.float32),
                      np.zeros((1, 1, 1600), np.float32))
    assert metric.compute() == 0.0


# ------------------------------------------------------------------ ViSQOL
def _pcm(path):
    with wave.open(str(path)) as f:
        return (f.getframerate(), f.getnchannels(),
                np.frombuffer(f.readframes(f.getnframes()), np.int16))


def _fake_visqol(root, log):
    """A stand-in `bazel-bin/visqol`: logs its input CSV, scores each pair
    by 1 + 4 x the mean absolute difference of its 16-bit samples / 2^15."""
    (root / "model").mkdir(parents=True)
    (root / "model" / "m.model").write_text("")
    (root / "bazel-bin").mkdir()
    script = root / "bazel-bin" / "visqol"
    script.write_text(f"""#!{sys.executable}
import csv, sys, wave
import numpy as np
def pcm(p):
    with wave.open(p) as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)
args = sys.argv
inp = args[args.index("--batch_input_csv") + 1]
out = args[args.index("--results_csv") + 1]
open({str(log)!r}, "a").write(inp + "\\n")
rows = list(csv.DictReader(open(inp)))
with open(out, "w") as f:
    w = csv.writer(f)
    w.writerow(["reference", "degraded", "moslqo"])
    for r in rows:
        d = pcm(r["reference"]).astype(float) - pcm(r["degraded"])
        score = 1 + 4 * np.abs(d).mean() / 2 ** 15
        w.writerow([r["reference"], r["degraded"], score])
""")
    script.chmod(0o755)


@pytest.mark.parametrize("mode, pad", [("audio", False), ("speech", True)])
def test_visqol_matches_jax(tmp_path, mode, pad):
    log = tmp_path / "inputs.log"
    _fake_visqol(tmp_path / "visqol", log)
    ref, deg = _music(17, 2, 0.3), _music(18, 2, 0.3)
    got = visqol.ViSQOL(tmp_path / "visqol", mode, model="m.model")(
        torch.from_numpy(ref), torch.from_numpy(deg), 32000, pad)
    want = jvisqol.ViSQOL(tmp_path / "visqol", mode, model="m.model")(
        ref, deg, 32000, pad)
    assert 1 < got < 5
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    csvs = log.read_text().split()
    pairs = [list(csv.DictReader(open(p))) for p in csvs]
    assert len(pairs[0]) == len(pairs[1]) == 2
    rate = 16000 if mode == "speech" else 48000
    for i, (a, b) in enumerate(zip(*pairs)):
        for key, stem in (("reference", "ref"), ("degraded", "deg")):
            assert a[key].endswith(f"{stem}_{i}.wav")
            (ra, ca, xa), (rb, cb, xb) = _pcm(a[key]), _pcm(b[key])
            assert (ra, ca, len(xa)) == (rb, cb, len(xb)) == (
                rate, 1, int(rate * (0.3 + pad)))
            # the two packages' resamplers differ by about 1e-6: one step
            # of 16-bit PCM at most
            assert np.abs(xa.astype(int) - xb).max() <= 1
    with pytest.raises(AssertionError, match="binary"):
        visqol.ViSQOL(tmp_path / "missing")
