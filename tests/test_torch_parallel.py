"""The port's last modules against the JAX package on the CPU, in one
process: the parameter placements of `parallel/sharding.py`, the one-process
distributed verbs and the mesh's checks, the two repaired conditioner
faults (the T5 tokenizer, the chroma conditioner's `eval_wavs`), the
`time_group_norm` and `spectral_norm` convolutions, and the audio helpers
`get_spec`, `save_spectrograms` and `wav_read_resample`. The multi-process
behaviour is in `tests/test_torch_multiprocess.py`.

Tolerances: the codec's codes are equal and its decode within 1e-5 (f32,
a narrow SEANet); a single conv within 1e-5; the mel spectrogram in dB
within 1e-5 of each value (1e-5 dB near the peak; the quietest bins,
80 dB under it, differ by a few f32 ulps of their power);
the native resampler within 2e-3 of the sinc resampler it mirrors (both
windowed sinc of 24 zero crossings, the native one in f32 with its own
window table)."""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.data import _native as jnative
from audiocraft_tpu.data import audio as jaudio
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models.encodec import EncodecModel as JaxEncodec
from audiocraft_tpu.models.lm import init_lm_params
from audiocraft_tpu.models.presets import musicgen_lm as jax_musicgen_lm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import conv as jconv
from audiocraft_tpu.modules import seanet as jseanet
from audiocraft_tpu.parallel import distrib as jdistrib
from audiocraft_tpu.parallel import mesh as jmesh
from audiocraft_tpu.parallel import sharding as jsharding
from audiocraft_tpu.quantization import vq as jvq
from audiocraft_tpu_torch.data import _native
from audiocraft_tpu_torch.data import audio as taudio
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.models.encodec import EncodecModel
from audiocraft_tpu_torch.models.presets import musicgen_lm
from audiocraft_tpu_torch.modules import conditioners as tcond
from audiocraft_tpu_torch.modules import conv as tconv
from audiocraft_tpu_torch.modules import seanet as tseanet
from audiocraft_tpu_torch.modules import t5 as tt5
from audiocraft_tpu_torch.ops.resample import resample_frac
from audiocraft_tpu_torch.parallel import distrib, mesh, sharding
from audiocraft_tpu_torch.quantization.vq import ResidualVectorQuantizer
from audiocraft_tpu_torch.utils import jax_weights

MESH = {"dp": 2, "fsdp": 2, "tp": 2}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- placements

def _flax_counterpart(name: str, kind: str, ndim: int):
    """(flax path, flax dim of each port dim) of a port LM parameter."""
    if re.fullmatch(r"emb\.\d+\.weight", name):
        return "params/emb", (1, 2)
    if re.fullmatch(r"linears\.\d+\.weight", name):
        return "params/linears", (2, 1)
    if re.fullmatch(r"linears\.\d+\.bias", name):
        return "params/linears_bias", (1,)
    path = name.replace("condition_provider.conditioners.",
                        "conditioners_")
    path = re.sub(r"layers\.(\d+)", r"layers_\1", path)
    path = path.replace("cross_attention", "cross_attn").replace(".", "/")
    leaf = path.rsplit("/", 1)[-1]
    if kind == "linear" and leaf == "weight":
        return "params/" + path[:-len("weight")] + "kernel", (1, 0)
    if kind == "linear":  # in_proj_weight: flax [E, E + 2 kv]
        return "params/" + path, (1, 0)
    if kind == "embedding":
        return "params/" + path[:-len("weight")] + "embedding", (0, 1)
    if leaf == "weight":  # a norm's scale
        path = path[:-len("weight")] + "scale"
    return "params/" + path, tuple(range(ndim))


def _jax_specs(params) -> dict:
    fake_mesh = SimpleNamespace(shape=MESH)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(jsharding.infer_param_spec(path, leaf, fake_mesh))
        out[jsharding._path_str(path)] = (spec + (None,) * leaf.ndim)[
            :leaf.ndim]
    return out


@pytest.fixture(scope="module")
def lm_pairs():
    _, jparams = jbuilders.get_debug_lm_model()
    jxs = jax_musicgen_lm("xsmall", n_q=4, card=64, dim=64, num_heads=4,
                          num_layers=2)
    return {
        "debug": (builders.get_debug_lm_model(device="cpu"),
                  _jax_specs(jparams)),
        "xsmall": (musicgen_lm("xsmall", n_q=4, card=64, dim=64, num_heads=4,
                               num_layers=2, device="cpu"),
                   _jax_specs(init_lm_params(jxs, jax.random.PRNGKey(0),
                                             seq_len=4))),
    }


@pytest.mark.parametrize("model", ["debug", "xsmall"])
def test_param_placements_match_the_jax_rules(lm_pairs, model):
    """On a dp 2 x fsdp 2 x tp 2 mesh every port parameter shards the dims
    of its flax counterpart (transposed where the layouts are) on the same
    axes, and the dims the port folds away (the codebook axis) are
    replicated."""
    port, jspecs = lm_pairs[model]
    seen, axes = set(), set()
    for prefix, module in port.named_modules():
        for name, param in module.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            kind = sharding._kind(module, name)
            spec = sharding.infer_param_spec(full, param.shape, MESH, kind)
            path, dims = _flax_counterpart(full, kind, param.ndim)
            jspec = jspecs[path]
            assert tuple(jspec[d] for d in dims) == spec, (full, spec, jspec)
            assert all(jspec[d] is None for d in range(len(jspec))
                       if d not in dims), (full, jspec)
            seen.add(path)
            axes.update(a for a in spec if a)
    assert seen == set(jspecs)
    assert axes == {"fsdp", "tp"}


def test_placements_become_dtensor_layouts():
    assert sharding.placements(("tp", "fsdp")) == [
        sharding.Replicate(), sharding.Shard(1), sharding.Shard(0)]
    assert sharding.placements((None,)) == [sharding.Replicate()] * 3


# ------------------------------------------------------- one-process verbs

def test_distributed_verbs_without_a_group():
    """No process group: the metrics pass through (a weight-0 key drops,
    as in the JAX package), the epoch guard and the barrier do nothing,
    `broadcast_tensors` leaves tensors as they are."""
    metrics = {"ce": 2.5, "fad": 7.0, "sisnr": np.float32(-3.0)}
    want = jdistrib.average_metrics(metrics, 3, weights={"fad": 0.0})
    assert distrib.average_metrics(metrics, 3, weights={"fad": 0.0}) == want \
        == {"ce": 2.5, "sisnr": -3.0}
    assert distrib.average_metrics({"ce": torch.tensor(1.5)}) == {"ce": 1.5}
    assert distrib.average_metrics({"ce": 1.0}, count=0) == {}
    distrib.check_epoch_consistency(3)
    distrib.barrier("alone")
    t = torch.arange(3.0)
    distrib.broadcast_tensors([t])
    assert t.tolist() == [0.0, 1.0, 2.0]
    assert (distrib.rank(), distrib.world_size(), distrib.is_distributed(),
            distrib.is_rank_zero()) == (0, 1, False, True)


@pytest.mark.parametrize("sizes", [dict(dp=-1, fsdp=-1), dict(dp=3),
                                   dict(dp=-1, fsdp=3)])
def test_create_mesh_refuses_what_the_jax_package_refuses(sizes):
    with pytest.raises(AssertionError) as jax_err:
        jmesh.create_mesh(**sizes, devices=[object()] * 4)
    with pytest.raises(AssertionError) as port_err:
        mesh.create_mesh(**sizes, world_size=4)
    assert str(port_err.value) == str(jax_err.value)


def test_batch_slices_follow_the_data_axes():
    rows = torch.arange(8)
    cut = mesh._BatchSlice(index=3, count=4)
    assert cut(rows).tolist() == [6, 7]
    tree = cut({"a": (rows, np.arange(8) * 2), "b": 5})
    assert tree["a"][0].tolist() == [6, 7]
    assert tree["a"][1].tolist() == [12, 14] and tree["b"] == 5
    with pytest.raises(AssertionError, match="does not split"):
        cut(torch.arange(6))
    assert mesh.constrain_batch(tree, None) is tree


# ------------------------------------------------------ conditioner faults

class _FakeT5Tokenizer:
    """Ids by a fixed hash of each word, padded with 0 to the longest
    text; the attention mask covers the words (an empty text keeps one
    end-of-sequence token, as sentencepiece's does)."""

    def __call__(self, entries, return_tensors="np", padding=True):
        assert return_tensors == "np" and padding
        ids = [[sum(map(ord, w)) % 1000 + 2 for w in e.split()] + [1]
               for e in entries]
        width = max(map(len, ids))
        out = np.zeros((len(ids), width), np.int64)
        mask = np.zeros((len(ids), width), np.int64)
        for i, row in enumerate(ids):
            out[i, :len(row)], mask[i, :len(row)] = row, 1
        return {"input_ids": out, "attention_mask": mask}


TEXTS = ["Hello world, rock", "", None, "a longer text with five words"]


def _t5_pair():
    port = tcond.T5Conditioner(output_dim=8, config=tt5.T5EncoderConfig(
        vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=1,
        num_heads=2))
    return port, jcond.T5Conditioner(model_name="t5-small", output_dim=8)


def test_t5_tokenize_uses_the_tokenizer_and_zeroes_empty_texts(monkeypatch):
    """One fake tokenizer in both packages (no download): equal ids and
    masks, the rows of the empty and missing texts masked out."""
    fake = _FakeT5Tokenizer()
    monkeypatch.setattr(jcond.T5Conditioner, "_get_tokenizer",
                        lambda self: fake)
    monkeypatch.setattr(tcond.T5Conditioner, "_get_tokenizer",
                        lambda self: fake)
    port, jax_cond = _t5_pair()
    ids, mask = port.tokenize(TEXTS)
    jids, jmask = jax_cond.tokenize(TEXTS)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert ids.dtype == mask.dtype == np.int32
    assert mask[1].sum() == mask[2].sum() == 0 and mask[0].sum() == 4


def test_t5_tokenize_falls_back_to_the_hash_without_a_tokenizer(monkeypatch):
    """With `transformers` absent the port's tokenizer lookup gives None
    (no download is tried) and both packages hash the words."""
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    port, jax_cond = _t5_pair()
    assert port._get_tokenizer() is None
    monkeypatch.setattr(jcond.T5Conditioner, "_get_tokenizer",
                        lambda self: None)
    ids, mask = port.tokenize(TEXTS)
    jids, jmask = jax_cond.tokenize(TEXTS)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


def test_chroma_conditioner_accepts_eval_wavs():
    """`eval_wavs` and `n_eval_wavs` are taken and ignored in both
    packages: the conditioner builds and conditions as without them."""
    kw = dict(sample_rate=16000, duration=1.0, eval_wavs="/nowhere/eval",
              n_eval_wavs=4)
    port = tcond.ChromaStemConditioner(8, device="cpu", **kw)
    plain = tcond.ChromaStemConditioner(8, device="cpu", sample_rate=16000,
                                        duration=1.0)
    plain.load_state_dict(port.state_dict())
    jcond.ChromaStemConditioner(output_dim=8, **kw)
    t = torch.arange(16000) / 16000
    wav = torch.sin(2 * np.pi * 440 * t)[None, None]
    cond = tcond.WavCondition(wav, torch.tensor([16000]), [16000])
    with torch.no_grad():
        got = port(port.tokenize(cond))
        want = plain(plain.tokenize(cond))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


# ------------------------------------------------------------- conv norms

def _codec_pair(norm: str, norm_params: dict):
    kw = dict(channels=1, dimension=16, n_filters=4, n_residual_layers=1,
              ratios=(4, 2), lstm=0, norm=norm, norm_params=norm_params)
    jmodel = JaxEncodec(jseanet.SEANetEncoder(**kw),
                        jseanet.SEANetDecoder(**kw),
                        jvq.ResidualVectorQuantizer(dimension=16, bins=32,
                                                    n_q=2, kmeans_init=False),
                        frame_rate=2000, sample_rate=16000, channels=1)
    jvars = _np(jmodel.init(jax.random.PRNGKey(1), segment_length=64))
    port = EncodecModel(tseanet.SEANetEncoder(**kw),
                        tseanet.SEANetDecoder(**kw),
                        ResidualVectorQuantizer(16, 2, 32, kmeans_init=False),
                        frame_rate=2000, sample_rate=16000, channels=1).eval()
    # move the group norms' scale and bias off 1 and 0 so that they matter
    rs = np.random.RandomState(2)
    jvars = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 * rs.randn(*x.shape).astype(np.float32)
        if "GroupNorm_0" in jsharding._path_str(p) else x, jvars)
    jax_weights.load_encodec(port, jvars)
    return jmodel, jvars, port


def test_time_group_norm_codec_matches_jax():
    """A SEANet codec under `time_group_norm` with `norm_params` (flax's
    names and epsilon): equal codes, decode within 1e-5; the norms carry
    over from flax's `GroupNorm_0`."""
    jmodel, jvars, port = _codec_pair("time_group_norm", {"epsilon": 1e-5})
    norms = [m for m in port.modules() if isinstance(m, tconv.TimeGroupNorm)]
    assert norms and all(n.epsilon == 1e-5 for n in norms)
    assert not torch.allclose(norms[0].weight, torch.ones_like(norms[0].weight))
    wav = (np.random.RandomState(3).randn(2, 1, 256) * 0.3).astype(np.float32)
    jcodes, _ = jmodel.encode(jvars, jnp.asarray(wav))
    codes, scale = port.encode(torch.from_numpy(wav), device="cpu")
    assert scale is None
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    expected = jmodel.decode(jvars, jcodes)
    got = port.decode(codes, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(use_bias=False, use_scale=False)])
def test_time_group_norm_conv2d_and_options_match_jax(kw):
    """`NormConv2d` (the discriminators') under `time_group_norm`, with
    flax's default epsilon 1e-6 or without the affine terms."""
    x = np.random.RandomState(4).randn(2, 9, 7, 3).astype(np.float32)  # NHWC
    jmod = jconv.NormConv2d(3, 5, (3, 3), padding=(1, 1),
                            norm="time_group_norm", norm_kwargs=kw)
    params = _np(jmod.init(jax.random.PRNGKey(5), x))
    expected = np.asarray(jmod.apply(params, x))
    port = tconv.NormConv2d(3, 5, (3, 3), padding=(1, 1),
                            norm="time_group_norm", norm_kwargs=kw)
    out: dict = {}
    jax_weights._conv2d(params["params"], "conv.", out)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in out.items()})
    assert port.norm.epsilon == 1e-6
    got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               expected, atol=1e-5, rtol=1e-5)


def test_spectral_norm_applies_no_normalisation():
    """As in the JAX package, `spectral_norm` leaves the kernel a plain
    parameter: the output of 'none' on the same weights, and JAX's."""
    x = np.random.RandomState(6).randn(2, 23, 6).astype(np.float32)
    jmod = jconv.StreamableConv1d(6, 5, kernel_size=7, stride=2,
                                  norm="spectral_norm")
    params = _np(jmod.init(jax.random.PRNGKey(6), x))
    expected = np.asarray(jmod.apply(params, x))
    spectral = tconv.StreamableConv1d(6, 5, kernel_size=7, stride=2,
                                      norm="spectral_norm")
    plain = tconv.StreamableConv1d(6, 5, kernel_size=7, stride=2, norm="none")
    out: dict = {}
    jax_weights._conv(params["params"]["conv"], "conv.conv.", False, out)
    state = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    spectral.load_state_dict(state)
    plain.load_state_dict(state)
    xt = torch.from_numpy(x.transpose(0, 2, 1))
    torch.testing.assert_close(spectral(xt), plain(xt), rtol=0, atol=0)
    np.testing.assert_allclose(spectral(xt).detach().numpy().transpose(0, 2, 1),
                               expected, atol=1e-5, rtol=1e-5)
    with pytest.raises(AssertionError, match="causal"):
        tconv.StreamableConv1d(6, 5, kernel_size=3, causal=True,
                               norm="time_group_norm")
    with pytest.raises(ValueError, match="unknown norm"):
        tconv.StreamableConv1d(6, 5, kernel_size=3, norm="batch_norm")


# ----------------------------------------------------------- audio helpers

def test_get_spec_matches_jax():
    y = (np.random.RandomState(7).randn(16000) * 0.1).astype(np.float32)
    y += np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    kw = dict(sr=16000, n_fft=512, hop_length=128, dur=0.8)
    got = taudio.get_spec(y, **kw)
    want = np.asarray(jaudio.get_spec(y, **kw))
    assert got.shape == want.shape == (128, 101)
    assert got.max() == 0.0 and got.min() >= -80.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_save_spectrograms_writes_a_png(tmp_path):
    ys = [np.random.RandomState(i).randn(8000).astype(np.float32)
          for i in range(3)]
    path = tmp_path / "plots" / "spec.png"
    taudio.save_spectrograms(ys, 16000, str(path), [], n_fft=256,
                             hop_length=64, dur=0.5)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(AssertionError, match="3 wavs but 2 names"):
        taudio.save_spectrograms(ys, 16000, str(path), ["a", "b"])


@pytest.mark.parametrize("target", [(32000, 1), (44100, 2), (16000, 2)])
def test_wav_read_resample_matches_read_then_resample(tmp_path, target):
    """The native fused read (decode, channel conversion, resampling) of a
    44.1 kHz stereo WAV: the JAX package's exactly, and the port's
    `audio_read` + mono down-mix + `resample_frac` within 2e-3."""
    target_sr, target_ch = target
    rs = np.random.RandomState(8)
    t = np.arange(44100) / 44100
    wav = np.stack([0.4 * np.sin(2 * np.pi * 330 * t),
                    0.3 * np.sin(2 * np.pi * 523 * t)]).astype(np.float32)
    wav += 0.01 * rs.randn(*wav.shape).astype(np.float32)
    path = taudio.audio_write(tmp_path / "x", wav, 44100, normalize=False)
    assert _native.available()
    got = _native.wav_read_resample(str(path), 0.25, 0.5, target_sr,
                                    target_ch)
    np.testing.assert_array_equal(
        got, jnative.wav_read_resample(str(path), 0.25, 0.5, target_sr,
                                       target_ch))
    read, sr = taudio.audio_read(path, 0.25, 0.5)
    if target_ch == 1:
        read = read.mean(axis=0, keepdims=True)
    want = resample_frac(torch.from_numpy(read), sr, target_sr).numpy()
    assert got.shape == (target_ch, target_sr // 2) == want.shape
    edge = 64  # the two resamplers pad the ends differently
    np.testing.assert_allclose(got[:, edge:-edge], want[:, edge:-edge],
                               atol=2e-3, rtol=0)
