"""The port's melody path vs the JAX package on the same inputs and weights
(small sizes, f32, greedy decoding on the CPU): STFT and spectrogram, the
chroma, HTDemucs stem separation and its checkpoint payload, the chroma
conditioner, the prepending fuser, and `debug-melody` generation under
batched, two-step and double CFG. The same paths on the card are tested in
`test_torch_gpu.py`.

Tolerances:
- STFT, iSTFT, spectrogram: atol 1e-4 * max(1, max |JAX|) (f32 FFTs of
  n_fft 256-1024, pocketfft against XLA's matmul-DFT or FFT);
- chroma filter bank: atol 1e-6 (the same float64 formula, cast to f32);
- chroma before the argmax: atol 1e-5 (inf-normalised to [0, 1]);
- chroma after the argmax and conditioner tokens: equal on frames whose
  two strongest classes differ by more than 1e-3 before the argmax (a
  one-hot argmax is discontinuous), and such frames are most of them;
- HTDemucs, its overlap-add and the melody mix-down: atol 1e-6 (outputs
  of order 0.05; f32 convolutions and attention summed in another order);
- resampling: atol 1e-5, as `test_torch_serving.py`;
- conditioner embeddings and LM logits: atol 1e-5;
- greedy tokens: equal; waveforms atol 1e-4 / rtol 1e-3 (f32 codec decode
  of equal codes, as `test_torch_musicgen.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.data.audio_utils import convert_audio as jax_convert_audio
from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu.modules import chroma as jchroma
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import demucs as jdemucs
from audiocraft_tpu.ops import stft as jstft
from audiocraft_tpu.utils.torch_port import load_htdemucs_from_path as jax_load
from audiocraft_tpu_torch.data.audio_utils import convert_audio
from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.models.lm import GenParams
from audiocraft_tpu_torch.modules import chroma, conditioners, demucs
from audiocraft_tpu_torch.modules.conditioners import (
    ChromaStemConditioner, ConditionFuser, ConditioningAttributes,
    WavCondition)
from audiocraft_tpu_torch.ops import stft
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

TINY = dict(sources=("drums", "bass", "other", "vocals"), audio_channels=2,
            channels=8, growth=2, depth=2, nfft=256, bottom_channels=16,
            t_depth=3, t_heads=2, dconv_compress=4, samplerate=8000,
            segment=0.5)
TEXTS = ["happy rock with loud drums", "jazz"]
WAV_TOL = dict(atol=1e-4, rtol=1e-3)
MARGIN = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tones(batch: int, seconds: float, sample_rate: int, channels: int = 1,
           seed: int = 0) -> np.ndarray:
    """[batch, channels, T] harmonic tones: per row a seeded pitch with
    three harmonics, so every chroma frame has a clear strongest class."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    rows = []
    for _ in range(batch):
        f0 = 220.0 * 2 ** (rs.randint(0, 12) / 12)
        wav = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * t + rs.rand() * 6)
                  for h in (1, 2, 3))
        rows.append(np.stack([wav * (1 - 0.1 * c) for c in range(channels)]))
    return np.stack(rows).astype(np.float32)


def _clear(pre: np.ndarray) -> np.ndarray:
    """Frames whose two strongest chroma classes differ by more than
    MARGIN: [..., frames] bool from [..., frames, n_chroma]."""
    top2 = np.sort(pre, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > MARGIN


# ------------------------------------------------------------------- STFT

@pytest.mark.parametrize("normalized", [False, True, "window"])
@pytest.mark.parametrize("n_fft,win", [(256, None), (1024, None), (512, 384)])
def test_stft_matches_jax(n_fft, win, normalized):
    x = np.random.RandomState(n_fft).randn(2, 3, 3000).astype(np.float32)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, n_fft // 4, win,
                                 normalized=normalized))
    got = stft.stft(torch.from_numpy(x), n_fft, n_fft // 4, win,
                    normalized=normalized).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("length", [None, 2900])
def test_istft_matches_jax_and_inverts(normalized, length):
    x = np.random.RandomState(1).randn(2, 3000).astype(np.float32)
    z = np.asarray(jstft.stft(jnp.asarray(x), 256, 64, normalized=normalized))
    want = np.asarray(jstft.istft(jnp.asarray(z), 256, 64,
                                  normalized=normalized, length=length))
    got = stft.istft(torch.from_numpy(z.copy()), 256, 64, normalized=normalized,
                     length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, x[:, :got.shape[-1]], rtol=0, atol=1e-4)


def test_istft_reads_only_the_real_part_of_the_dc_and_nyquist_bins():
    """A spectrum whose first and last bins carry imaginary parts (as the
    separator's masked output does) inverts as the JAX package's inverse
    DFT does: those parts do not enter."""
    rs = np.random.RandomState(21)
    z = (rs.randn(2, 129, 40) + 1j * rs.randn(2, 129, 40)).astype(np.complex64)
    want = np.asarray(jstft.istft(jnp.asarray(z), 256, 64, normalized=True,
                                  length=2500))
    got = stft.istft(torch.from_numpy(z), 256, 64, normalized=True,
                     length=2500).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    real_ends = z.copy()
    real_ends[:, [0, -1]] = real_ends[:, [0, -1]].real
    same = stft.istft(torch.from_numpy(real_ends), 256, 64, normalized=True,
                      length=2500).numpy()
    np.testing.assert_array_equal(got, same)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram_matches_jax(normalized, power):
    x = np.random.RandomState(2).randn(2, 4000).astype(np.float32)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), 512, 128, power=power,
                                        normalized=normalized))
    got = stft.spectrogram(torch.from_numpy(x), 512, 128, power=power,
                           normalized=normalized).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_spectrogram_normalises_by_the_window_and_stft_by_n_fft():
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 2048).astype(np.float32))
    plain = stft.stft(x, 512, 128)
    window = torch.hann_window(512)
    torch.testing.assert_close(stft.stft(x, 512, 128, normalized=True),
                               plain / 512 ** 0.5)
    torch.testing.assert_close(stft.spectrogram(x, 512, 128, normalized=True),
                               plain.abs().square() / window.square().sum())


# ----------------------------------------------------------------- chroma

@pytest.mark.parametrize("sr,n_fft", [(32000, 1024), (32000, 16384),
                                      (8000, 512)])
def test_chroma_filters_equal_jax(sr, n_fft):
    np.testing.assert_allclose(chroma.chroma_filters(sr, n_fft),
                               jchroma.chroma_filters(sr, n_fft), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seconds,channels", [(1.0, 1), (0.75, 2), (0.02, 1)])
def test_chroma_extractor_matches_jax(seconds, channels):
    wav = _tones(2, seconds, 32000, channels, seed=4)
    pre_j = np.asarray(jchroma.ChromaExtractor(32000, radix2_exp=10)(
        jnp.asarray(wav)))
    pre = chroma.ChromaExtractor(32000, radix2_exp=10)(torch.from_numpy(wav))
    np.testing.assert_allclose(pre.numpy(), pre_j, rtol=0, atol=1e-5)
    hot_j = np.asarray(jchroma.ChromaExtractor(32000, radix2_exp=10,
                                               argmax=True)(jnp.asarray(wav)))
    hot = chroma.ChromaExtractor(32000, radix2_exp=10, argmax=True)(
        torch.from_numpy(wav)).numpy()
    clear = _clear(pre_j)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(hot[clear], hot_j[clear])
    assert set(np.unique(hot)) <= {0.0, 1.0} and (hot.sum(-1) == 1).all()


# ---------------------------------------------------------------- HTDemucs

@pytest.fixture(scope="module")
def tiny_demucs():
    jm = jdemucs.HTDemucs(**TINY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4000)))
    port = demucs.HTDemucs(**TINY).eval()
    jax_weights.load_htdemucs(port, _np(params))
    return jm, params, port


@pytest.mark.parametrize("T", [4000, 1000])
def test_htdemucs_forward_matches_jax(tiny_demucs, T):
    jm, params, port = tiny_demucs
    x = np.random.RandomState(T).randn(2, 2, T).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 2, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("T", [int(2.6 * 4000), 1200])
def test_apply_demucs_matches_jax(tiny_demucs, T):
    """Several overlapping windows, and an input shorter than one."""
    jm, params, port = tiny_demucs
    mix = np.random.RandomState(5).randn(1, 2, T).astype(np.float32) * 0.1
    want = jdemucs.apply_demucs(jm, params, mix)
    got = demucs.apply_demucs(port, torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (1, 4, 2, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sr,channels", [(12000, 1), (32000, 1), (8000, 2)])
def test_separate_melody_matches_jax(tiny_demucs, sr, channels):
    jm, params, port = tiny_demucs
    wav = _tones(2, 0.7, sr, channels, seed=6)
    want = jdemucs.separate_melody(jm, params, wav, sr)
    got = demucs.separate_melody(port, torch.from_numpy(wav), sr).numpy()
    assert got.shape == want.shape and got.shape[:2] == (2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _save_payload(tmp_path, model: demucs.HTDemucs):
    """A demucs-package payload of `model` (`{'klass', 'kwargs', 'state'}`)."""
    path = tmp_path / "htdemucs.th"
    torch.save({"klass": "HTDemucs",
                "kwargs": {"sources": list(TINY["sources"]),
                           "samplerate": TINY["samplerate"],
                           "segment": TINY["segment"],
                           "t_heads": TINY["t_heads"]},
                "state": model.state_dict()}, path)
    return path


def test_demucs_payload_reads_back_in_both_packages(tmp_path):
    torch.manual_seed(7)
    model = demucs.HTDemucs(**TINY).eval()
    path = _save_payload(tmp_path, model)
    loaded = demucs.load_htdemucs_from_path(path, device="cpu")
    assert loaded.sources == TINY["sources"] and loaded.nfft == TINY["nfft"]
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    assert demucs.infer_htdemucs_config(model.state_dict())["dconv_compress"] == 4
    x = np.random.RandomState(8).randn(1, 2, 4000).astype(np.float32) * 0.1
    jm, variables = jax_load(path)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_stem_separator_from_the_environment(tmp_path, monkeypatch):
    torch.manual_seed(9)
    path = _save_payload(tmp_path, demucs.HTDemucs(**TINY))
    monkeypatch.delenv("DEMUCS_CHECKPOINT", raising=False)
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path / "none"))
    assert demucs.get_stem_separator("cpu") is None
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path))
    first = demucs.get_stem_separator("cpu")
    assert isinstance(first, demucs.HTDemucs)
    monkeypatch.setenv("DEMUCS_CHECKPOINT", str(path))
    assert demucs.get_stem_separator("cpu") is demucs.get_stem_separator("cpu")


# ------------------------------------------------------------- conversion

@pytest.mark.parametrize("src,dst,channels", [(44100, 32000, 1),
                                              (32000, 44100, 2)])
def test_convert_audio_at_the_melody_rates_matches_jax(src, dst, channels):
    wav = _tones(2, 0.3, src, 3 - channels, seed=10)
    want = np.asarray(jax_convert_audio(jnp.asarray(wav), src, dst, channels))
    got = convert_audio(torch.from_numpy(wav), src, dst, channels).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ conditioner

def _jax_cond(**kw):
    return jcond.ChromaStemConditioner(dim=12, output_dim=16,
                                       sample_rate=32000, n_chroma=12,
                                       radix2_exp=10, duration=1.0, **kw)


def _conditioners(match_len):
    jc = _jax_cond(match_len_on_eval=match_len)
    tok = jc.tokenize(jcond.WavCondition(np.zeros((1, 1, 3200), np.float32),
                                         np.array([3200]), [32000], [None]))
    variables = jc.init(jax.random.PRNGKey(1), tok)
    port = ChromaStemConditioner(16, 32000, 12, 10, duration=1.0,
                                 match_len_on_eval=match_len, device="cpu")
    state = {}
    jax_weights._dense(_np(variables)["params"]["output_proj"],
                       "output_proj.", state)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in state.items()})
    return jc, variables, port


def _wav_batch(seconds=0.4, null_row=True):
    wav = _tones(2, seconds, 32000, seed=11)
    lengths = np.array([wav.shape[-1], 0 if null_row else wav.shape[-1]])
    if null_row:
        wav[1] = 0.0
    return (jcond.WavCondition(wav, lengths, [32000, 32000], [None, None]),
            WavCondition(torch.from_numpy(wav), torch.from_numpy(lengths),
                         [32000, 32000], [None, None]))


@pytest.mark.parametrize("match_len", [True, False])
@pytest.mark.parametrize("seconds", [0.4, 1.5])
def test_chroma_conditioner_without_separator_matches_jax(match_len, seconds,
                                                           monkeypatch):
    monkeypatch.delenv("DEMUCS_CHECKPOINT", raising=False)
    monkeypatch.delenv("AUDIOCRAFT_CACHE_DIR", raising=False)
    jc, variables, port = _conditioners(match_len)
    jx, px = _wav_batch(seconds)
    jtok, ptok = jc.tokenize(jx), port.tokenize(px)
    assert isinstance(ptok, WavCondition) and ptok is px
    je, jm = (np.asarray(a) for a in jc.apply(variables, jtok))
    pe, pm = (a.detach().numpy() for a in port(ptok))
    assert pe.shape == je.shape
    if match_len:
        assert pe.shape[1] == port.chroma_len == 1 + 32000 // 256
    np.testing.assert_array_equal(pm, jm.astype(np.int32))
    assert pm[1].max() == 0 and np.abs(pe[1]).max() == 0
    pre = np.asarray(jchroma.ChromaExtractor(32000, radix2_exp=10)(
        jnp.asarray(jx.wav)))[0]
    frames = _clear(pre)[:pe.shape[1]] if not match_len else None
    if frames is None:  # tiled: the pattern of the clear frames repeats
        reps = -(-pe.shape[1] // pre.shape[0])
        frames = np.tile(_clear(pre), reps)[:pe.shape[1]]
    np.testing.assert_allclose(pe[0][frames], je[0][frames], rtol=0, atol=1e-5)


def test_chroma_conditioner_null_condition_is_one_zero_frame():
    jc, variables, port = _conditioners(True)
    null = conditioners.nullify_wav(_wav_batch()[1])
    assert tuple(null.wav.shape) == (2, 1, 1) and int(null.length.sum()) == 0
    embeds, mask = port(port.tokenize(null))
    je, jm = jc.apply(variables, jc.tokenize(jcond.nullify_wav(_wav_batch()[0])))
    assert tuple(embeds.shape) == np.asarray(je).shape == (2, 1, 16)
    assert embeds.abs().max() == 0 and mask.max() == 0


def test_chroma_conditioner_with_separator_matches_jax(tmp_path, monkeypatch):
    """Both packages read one demucs payload from DEMUCS_CHECKPOINT; the
    port's injected separator gives the same tokens."""
    torch.manual_seed(12)
    model = demucs.HTDemucs(**TINY).eval()
    monkeypatch.setenv("DEMUCS_CHECKPOINT", str(_save_payload(tmp_path, model)))
    jdemucs._SEPARATOR_CACHE.clear()
    # loaded here first: the JAX package cannot build the separator from
    # inside a conditioner's method (flax would make it a submodule)
    jm, jvars = jdemucs.get_stem_separator()
    jc, variables, port = _conditioners(True)
    jx, px = _wav_batch(0.4)
    jtok = jc.tokenize(jx)
    ptok = port.tokenize(px)
    assert isinstance(jtok, dict) and isinstance(ptok, dict)
    n_frames = 1 + px.wav.shape[-1] // 256
    assert tuple(ptok["chroma"].shape) == (2, n_frames, 12)
    assert ptok["chroma"][1].abs().max() == 0
    stems = jdemucs.separate_melody(jm, jvars, jx.wav[:1], 32000)
    pre = np.asarray(jchroma.ChromaExtractor(32000, radix2_exp=10)(
        jnp.asarray(stems)))[0, :n_frames]
    pstems = demucs.separate_melody(model, px.wav[:1], 32000)
    ppre = chroma.ChromaExtractor(32000, radix2_exp=10)(pstems)[0, :n_frames]
    np.testing.assert_allclose(ppre.numpy(), pre, rtol=0, atol=1e-5)
    clear = _clear(pre)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ptok["chroma"][0].numpy()[clear],
                                  jtok["chroma"][0][clear])
    port.set_separator(model)
    monkeypatch.delenv("DEMUCS_CHECKPOINT")
    injected = port.tokenize(px)
    torch.testing.assert_close(injected["chroma"], ptok["chroma"])
    je, _ = jc.apply(variables, jtok)
    pe, pm = port(ptok)
    assert tuple(pe.shape) == (2, port.chroma_len, 16)
    assert pm[1].max() == 0 and pe[1].abs().max() == 0
    reps = -(-port.chroma_len // n_frames)
    frames = np.tile(clear, reps)[:port.chroma_len]
    np.testing.assert_allclose(pe[0].detach().numpy()[frames],
                               np.asarray(je)[0][frames], rtol=0, atol=1e-5)
    jdemucs._SEPARATOR_CACHE.clear()


def test_chroma_conditioner_refuses_unported_options():
    # the embedding cache is ported (`test_torch_data_train.py` holds it
    # against the JAX package) and eval_wavs is accepted as there
    # (`test_torch_parallel.py`); a wrong dim still raises
    with pytest.raises(ValueError):
        ChromaStemConditioner(16, dim=13, device="cpu")


# ------------------------------------------------------------------ fuser

def test_fuser_prepends_in_the_order_of_the_conditions():
    """Texts are tokenized before waveforms, so [chroma, description, x]."""
    rs = np.random.RandomState(13)
    x, desc, wav = (rs.randn(2, n, 4).astype(np.float32) for n in (3, 5, 2))
    fuse = {"prepend": ["self_wav", "description"], "cross": [], "sum": []}
    conds = {"description": (desc, np.ones((2, 5))),
             "self_wav": (wav, np.ones((2, 2)))}
    want, cross_j = jcond.ConditionFuser(fuse)(
        jnp.asarray(x), {k: (jnp.asarray(a), jnp.asarray(m))
                         for k, (a, m) in conds.items()})
    fuser = ConditionFuser(fuse)
    got, cross = fuser(torch.from_numpy(x), {
        k: (torch.from_numpy(a), torch.from_numpy(m))
        for k, (a, m) in conds.items()})
    assert cross is None and cross_j is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([wav, desc, x], axis=1))
    assert fuser.prepend_length({k: (torch.from_numpy(a), None)
                                 for k, (a, m) in conds.items()}) == 7
    same, _ = fuser(torch.from_numpy(x), {
        k: (torch.from_numpy(a), None) for k, (a, m) in conds.items()},
        first_step=False)
    assert torch.equal(same, torch.from_numpy(x))


@pytest.mark.parametrize("op", ["sum", "input_interpolate"])
def test_fuser_sum_and_interpolate_match_jax(op):
    rs = np.random.RandomState(14)
    x = rs.randn(2, 6, 4).astype(np.float32)
    c = rs.randn(2, 6 if op == "sum" else 4, 4).astype(np.float32)
    want, _ = jcond.ConditionFuser({op: ["c"]})(
        jnp.asarray(x), {"c": (jnp.asarray(c), jnp.ones((2, c.shape[1])))})
    got, _ = ConditionFuser({op: ["c"]})(
        torch.from_numpy(x), {"c": (torch.from_numpy(c), None)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# -------------------------------------------------------------- debug-melody

@pytest.fixture(scope="module")
def melody_models():
    jmg = JaxMusicGen.get_pretrained("debug-melody")
    codec = builders.get_debug_compression_model(device="cpu")
    jax_weights.load_encodec(codec, _np(jmg.compression_variables))
    lm = builders.get_debug_melody_lm_model(device="cpu")
    jax_weights.load_lm(lm, _np(jmg.lm_params))
    return jmg, MusicGen("debug-melody", codec, lm, max_duration=30,
                         device="cpu")


MELODY = _tones(2, 0.8, 44100, channels=2, seed=15)
CFG_MODES = {"batched": {}, "two_step": {"two_step_cfg": True},
             "double": {"cfg_coef_beta": 5.0}}


def _generate(jmg, mg, kw, duration=0.5):
    jmg.set_generation_params(duration=duration, use_sampling=False, **kw)
    mg.set_generation_params(duration=duration, use_sampling=False, **kw)
    jw, jt = jmg.generate_with_chroma(TEXTS, MELODY, 44100, return_tokens=True)
    pw, pt = mg.generate_with_chroma(TEXTS, torch.from_numpy(MELODY), 44100,
                                     return_tokens=True)
    return np.asarray(jw), np.asarray(jt), pw.numpy(), pt.numpy()


@pytest.mark.parametrize("mode", list(CFG_MODES))
def test_debug_melody_generation_matches_jax(melody_models, mode):
    jw, jt, pw, pt = _generate(*melody_models, CFG_MODES[mode])
    assert pt.shape == (2, 4, 12) and pw.shape == (2, 1, 12 * 1280)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pw, jw, **WAV_TOL)


def test_batched_and_two_step_cfg_differ_on_the_melody_model(melody_models):
    """A batched null row carries zeros of the conditional rows' prefix
    length; a two-step null stream prepends one zero frame: the modes give
    different tokens, in both packages alike."""
    jmg, mg = melody_models
    _, jt_b, _, pt_b = _generate(jmg, mg, {})
    _, jt_t, _, pt_t = _generate(jmg, mg, {"two_step_cfg": True})
    assert not np.array_equal(pt_b, pt_t)
    assert not np.array_equal(jt_b, jt_t)
    np.testing.assert_array_equal(pt_b, jt_b)
    np.testing.assert_array_equal(pt_t, jt_t)
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    wav = _tones(1, 0.5, 32000, seed=19)
    for a in attrs:
        a.wav["self_wav"] = WavCondition(torch.from_numpy(wav),
                                         torch.tensor([wav.shape[-1]]),
                                         [32000], [None])
    cond, null = mg.lm.prepare_cfg_conditions(attrs, two_step=True)
    assert null["self_wav"][0].shape[1] == 1
    assert cond["self_wav"][0].shape[1] == mg.lm.condition_provider \
        .conditioners["self_wav"].chroma_len


def test_double_cfg_rows_drop_the_description_only(melody_models):
    """Double CFG's rows: conditional, description dropped with the melody
    kept, then null, as the JAX package's `drop_description_condition`."""
    _, mg = melody_models
    wav = _tones(1, 0.5, 32000, seed=18)
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    jattrs = [jcond.ConditioningAttributes(text={"description": t})
              for t in TEXTS]
    for a, ja in zip(attrs, jattrs):
        a.wav["self_wav"] = WavCondition(torch.from_numpy(wav),
                                         torch.tensor([wav.shape[-1]]),
                                         [32000], [None])
        ja.wav["self_wav"] = jcond.WavCondition(wav, np.array([wav.shape[-1]]),
                                                [32000], [None])
    ct = mg.lm.prepare_cfg_conditions(attrs, cfg_coef_beta=2.0)
    mask, wav_mask = ct["description"][1], ct["self_wav"][1]
    assert mask.shape[0] == wav_mask.shape[0] == 6
    assert mask[:2, 0].min() == 1 and mask[2:].max() == 0
    assert wav_mask[:4].min() == 1 and wav_mask[4:].max() == 0
    ours = conditioners.drop_description_condition(attrs)
    theirs = jcond.drop_description_condition(jattrs)
    assert [a.text["description"] for a in ours] == \
        [a.text["description"] for a in theirs] == [None, None]
    assert [int(a.wav["self_wav"].length[0]) for a in ours] == \
        [int(a.wav["self_wav"].length[0]) for a in theirs] == [wav.shape[-1]] * 2
    assert attrs[0].text["description"] == TEXTS[0]  # the input is kept


def test_prepend_lm_logits_match_jax(melody_models):
    """The training forward cuts the prepended prefix from the logits."""
    jmg, mg = melody_models
    from audiocraft_tpu.models import lm as jlm
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    jattrs = jmg._prepare_tokens_and_attributes(TEXTS, None)[0]
    wav = _tones(2, 0.5, 32000, seed=16)
    for i in range(2):
        attrs[i].wav["self_wav"] = WavCondition(torch.from_numpy(wav[i:i + 1]),
                                                torch.tensor([wav.shape[-1]]),
                                                [32000], [None])
        jattrs[i].wav["self_wav"] = jcond.WavCondition(
            wav[i:i + 1], np.array([wav.shape[-1]]), [32000], [None])
    codes = np.random.RandomState(17).randint(0, 400, (2, 4, 9))
    jct = jlm.jit_compute_conditions(jmg.lm, jmg.lm_params,
                                     jlm.tokenize_conditions(jmg.lm, jattrs))
    want = jmg.lm.apply(jmg.lm_params, jnp.asarray(codes), jct,
                        method=type(jmg.lm).compute_predictions)
    with torch.no_grad():
        ct = mg.lm.compute_conditions(mg.lm.condition_provider.tokenize(attrs))
        got = mg.lm.compute_predictions(torch.from_numpy(codes), ct)
    assert tuple(got.logits.shape) == (2, 4, 9, 400)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=1e-5)


def test_melody_model_without_melody_and_with_none(melody_models):
    """`generate` gives every row the null melody; a None melody does too."""
    jmg, mg = melody_models
    mg.set_generation_params(duration=0.5, use_sampling=False)
    jmg.set_generation_params(duration=0.5, use_sampling=False)
    _, pt = mg.generate(TEXTS, return_tokens=True)
    _, jt = jmg.generate(TEXTS, return_tokens=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    _, pt_none = mg.generate_with_chroma(TEXTS, [None, None], 44100,
                                         return_tokens=True)
    np.testing.assert_array_equal(pt_none.numpy(), pt.numpy())


def test_debug_melody_from_get_pretrained_runs():
    mg = MusicGen.get_pretrained("debug-melody", device="cpu")
    mg.set_generation_params(duration=0.5, use_sampling=False)
    wav, tokens = mg.generate_with_chroma(["calm"], torch.from_numpy(MELODY[0]),
                                          44100, return_tokens=True)
    assert tuple(wav.shape) == (1, 1, 12 * 1280) and tuple(tokens.shape) == (1, 4, 12)
    assert torch.isfinite(wav).all()
    with pytest.raises(AssertionError, match="melody"):
        MusicGen.get_pretrained("debug", device="cpu").generate_with_chroma(
            ["calm"], torch.from_numpy(MELODY[0]), 44100)


# ---------------------------------------------------------------- packages

MELODY_LM_CFG = {
    "transformer_lm": {"n_q": 4, "card": 400, "dim": 16, "num_heads": 4,
                       "num_layers": 2, "hidden_scale": 4,
                       "norm_first": False, "bias_proj": True, "causal": True},
    "codebooks_pattern": {"modeling": "delay",
                          "delay": {"delays": [0, 1, 2, 3]}},
    "conditioners": {
        "description": {"model": "lut", "lut": {
            "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}},
        "self_wav": {"model": "chroma_stem", "chroma_stem": {
            "sample_rate": 32000, "n_chroma": 12, "radix2_exp": 12,
            "match_len_on_eval": False, "eval_wavs": None,
            "n_eval_wavs": 100, "cache_path": None}}},
    "fuser": {"cross": ["description"], "prepend": ["self_wav"], "sum": [],
              "input_interpolate": []},
    "classifier_free_guidance": {"inference_coef": 3.0},
    "dataset": {"segment_duration": 30}}
CODEC_CFG = {"compression_model": "encodec", "sample_rate": 32000,
             "channels": 1,
             "seanet": {"dimension": 32, "n_filters": 4,
                        "n_residual_layers": 1, "ratios": [10, 8, 16],
                        "lstm": 0, "norm": "none"},
             "rvq": {"n_q": 4, "bins": 400}}


def test_melody_packages_load_in_both_packages(tmp_path):
    """A seeded melody LM saved as an export package (with the chroma
    window buffer upstream's exports may carry) builds through
    `get_lm_model`, keeps upstream's keys, matches the chroma to 30 s once
    loaded, and generates the JAX package's greedy tokens."""
    lm = builders.get_lm_model(MELODY_LM_CFG, device="cpu", seed=20)
    lm.reset_parameters(20)
    codec = builders.get_debug_compression_model(device="cpu", seed=21)
    state = dict(lm.state_dict())
    assert "condition_provider.conditioners.self_wav.output_proj.weight" in state
    state["condition_provider.conditioners.self_wav.chroma.spec.window"] = \
        torch.hann_window(4096)
    torch.save({"best_state": state, "xp.cfg": MELODY_LM_CFG},
               tmp_path / "state_dict.bin")
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    mg = MusicGen.get_pretrained(str(tmp_path), device="cpu")
    cond = mg.lm.condition_provider.conditioners["self_wav"]
    assert isinstance(cond, ChromaStemConditioner) and cond.match_len_on_eval
    assert cond.chroma_len == 1 + 30 * 32000 // 1024
    for key, value in lm.state_dict().items():
        assert torch.equal(mg.lm.state_dict()[key], value), key
    jmg = JaxMusicGen.get_pretrained(str(tmp_path))
    for model in (mg, jmg):
        model.set_generation_params(duration=0.2, use_sampling=False)
    melody = _tones(1, 2.0, 32000, seed=22)
    _, jt = jmg.generate_with_chroma(["calm"], melody, 32000,
                                     return_tokens=True)
    _, pt = mg.generate_with_chroma(["calm"], torch.from_numpy(melody), 32000,
                                    return_tokens=True)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_generate_defaults_to_gen_params(melody_models):
    """`GenParams` carries double CFG to `LMModel.generate` directly."""
    _, mg = melody_models
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    codes = mg.lm.generate(conditions=attrs, max_gen_len=6, device="cpu",
                           gen=GenParams(use_sampling=False, cfg_coef_beta=2.0))
    assert tuple(codes.shape) == (2, 4, 6)
    assert int(codes.min()) >= 0 and int(codes.max()) < 400
