"""The checkpoint formats the port reads beside audiocraft's export packages,
against the JAX package reading the same files (small sizes, f32, CPU):

- an upstream-layout LM package without the T5 encoder's keys (upstream
  keeps T5 out of the state dict): it loads, the encoder keeps the seeded
  init, and with the same T5 weights carried into both packages it gives
  the JAX package's greedy tokens; any other missing or unexpected key
  still raises;
- the JAX package's own `.npz` export of a codec (`export_encodec`), and a
  Hugging Face EnCodec snapshot (`config.json` + `model.safetensors`
  written by `safetensors.numpy.save_file`, or `pytorch_model.bin`) of a
  debug-width `transformers.EncodecModel`: each decodes the same codes to
  the JAX package's waveform; a snapshot the port writes
  (`hf_encodec_state_dict`) has Hugging Face's keys and round-trips;
- MERT from a safetensors-only snapshot;
- the port's numpy safetensors reader and writer against the
  `safetensors` package, for every dtype it reads, and its refusals;
- the solvers' `compression_model_checkpoint` as a package path.

Tolerances: tokens equal (greedy, f32); waveforms atol 1e-4 / rtol 1e-3
(f32 decodes of equal codes, as `test_torch_loaders.py`); a snapshot
written from plain weights atol 1e-5 (its weight-norm form rounds each
weight once); safetensors tensors and MERT weights equal.
"""
import json

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from transformers import EncodecConfig
from transformers import EncodecModel as HFEncodecModel

from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu.models import loaders as jax_loaders
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.utils import export as jexport
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import MusicGen, builders, loaders
from audiocraft_tpu_torch.modules import mert, t5 as tt5
from audiocraft_tpu_torch.solvers import get_solver
from audiocraft_tpu_torch.utils import jax_weights
from audiocraft_tpu_torch.utils import safetensors as st
from tests.test_torch_loaders import CODEC_CFG, LM_CFG, TEXTS
from tests.test_torch_mbd import (_jax_codec, _one_torch_thread,  # noqa: F401
                                   _perturbed)
from tests.test_torch_style import TINY_MERT, _hf_state

WAV_TOL = dict(atol=1e-4, rtol=1e-3)
T5_CFG = {**LM_CFG, "conditioners": {"description": {"model": "t5", "t5": {
    "name": "t5-small", "finetune": False}}}}
T5_PREFIX = "condition_provider.conditioners.description.t5."


def _codes(n_q, bins, frames=6, seed=0):
    return np.random.RandomState(seed).randint(0, bins, (2, n_q, frames))


# ------------------------------------------------- LM packages without T5

@pytest.fixture(scope="module")
def t5_package(tmp_path_factory):
    """An LM with a t5-small conditioner saved as upstream does: its state
    dict without the T5 encoder's keys; beside it the debug codec."""
    root = tmp_path_factory.mktemp("musicgen-t5-export")
    lm = builders.get_lm_model(T5_CFG, device="cpu", seed=5)
    lm.reset_parameters(5)
    state = {k: v for k, v in lm.state_dict().items()
             if not k.startswith(T5_PREFIX)}
    torch.save({"best_state": state, "xp.cfg": T5_CFG}, root / "state_dict.bin")
    codec = builders.get_debug_compression_model(device="cpu", seed=3)
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               root / "compression_state_dict.bin")
    return root, lm


def test_lm_package_without_t5_keys_loads_with_the_seeded_t5(t5_package):
    root, lm = t5_package
    loaded, _ = loaders.load_lm_model(str(root), device="cpu")
    seeded = builders.get_lm_model(T5_CFG, device="cpu").state_dict()
    for key, value in loaded.state_dict().items():
        want = seeded[key] if key.startswith(T5_PREFIX) else lm.state_dict()[key]
        assert torch.equal(value, want), key


def test_lm_package_without_t5_keys_matches_jax_greedy_tokens(
        t5_package, monkeypatch):
    """The same T5 weights (a seed-7 t5-small carried by the JAX package's
    converter from Hugging Face names, then into the port by
    `jax_weights.load_t5`) in both packages: equal greedy tokens. The JAX
    loader leaves the T5 encoder out of its parameters (its generate would
    raise), so they are put there. The JAX T5 tokenizer would look for a
    vocabulary online; both use the hash fallback."""
    root, _ = t5_package
    monkeypatch.setattr(jcond.T5Conditioner, "_get_tokenizer",
                        lambda self: None)
    torch.manual_seed(7)
    encoder = tt5.T5Encoder(tt5.T5EncoderConfig.for_model("t5-small"))
    t5_params = torch_port.convert_t5_encoder(
        {k: v.numpy() for k, v in encoder.state_dict().items()},
        num_layers=6)
    jmg = JaxMusicGen.get_pretrained(str(root))
    jmg.lm_params["params"]["conditioners_description"]["t5"] = jax.tree.map(
        jax.numpy.asarray, t5_params)
    jmg.set_generation_params(use_sampling=False, duration=0.5)
    _, jtok = jmg.generate(TEXTS, return_tokens=True)
    mg = MusicGen.get_pretrained(str(root), device="cpu")
    jax_weights.load_t5(mg.lm.condition_provider.conditioners["description"].t5,
                        t5_params)
    mg.set_generation_params(use_sampling=False, duration=0.5)
    _, tok = mg.generate(TEXTS, return_tokens=True)
    assert tok.shape == (2, 4, 12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("fault", ["missing", "unexpected", "partial_t5"])
def test_lm_package_with_another_key_fault_raises(t5_package, tmp_path, fault):
    _, lm = t5_package
    state = {k: v for k, v in lm.state_dict().items()
             if not k.startswith(T5_PREFIX)}
    if fault == "missing":
        del state["linears.0.weight"]
    elif fault == "unexpected":
        state["linears.9.weight"] = state["linears.0.weight"]
    else:
        key = T5_PREFIX + "shared.weight"
        state[key] = lm.state_dict()[key]
    torch.save({"best_state": state, "xp.cfg": T5_CFG},
               tmp_path / "state_dict.bin")
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        loaders.load_lm_model(str(tmp_path), device="cpu")


# -------------------------------------------------------- codec packages

def test_jax_npz_export_decodes_as_in_jax(tmp_path):
    """`export_encodec` of the JAX debug codec (its weights carried from a
    perturbed port debug codec): the port reads the npz, and in a directory
    that also holds a `compression_state_dict.bin` the npz wins, as in the
    JAX package's lookup."""
    port = _perturbed(builders.get_debug_compression_model(device="cpu",
                                                           seed=4), seed=4)
    jmodel, jvars = _jax_codec(port)
    jexport.export_encodec(jvars, jexport.encodec_model_cfg(jmodel),
                           tmp_path / "codec.npz")
    other = builders.get_debug_compression_model(device="cpu", seed=9)
    torch.save({"best_state": other.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    loaded = loaders.load_compression_model(str(tmp_path), device="cpu")
    codes = _codes(4, 400)
    jm, jv = jax_loaders.load_compression_model(str(tmp_path))
    want = np.asarray(jm.decode(jv, jax.numpy.asarray(codes)))
    got = loaded.decode(torch.from_numpy(codes), device="cpu").numpy()
    assert got.shape == want.shape == (2, 1, 6 * 1280)
    np.testing.assert_allclose(got, want, **WAV_TOL)
    for key, value in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[key], value, rtol=0,
                                   atol=0)


HF_CFG = dict(sampling_rate=32000, audio_channels=1, hidden_size=32,
              num_filters=4, num_residual_layers=1, upsampling_ratios=[16, 8, 10],
              codebook_size=256, num_lstm_layers=1, use_conv_shortcut=True,
              norm_type="weight_norm", target_bandwidths=[0.8],
              normalize=False)


def _hf_snapshot(root, fmt, seed=0):
    """A debug-width `transformers.EncodecModel` (its own module names and
    weight-norm parametrizations; every weight perturbed by seeded noise)
    as a snapshot directory."""
    config = EncodecConfig(**HF_CFG)
    torch.manual_seed(seed)
    hf = _perturbed(HFEncodecModel(config), seed)
    state = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    root.mkdir(exist_ok=True)
    (root / "config.json").write_text(json.dumps(config.to_dict()))
    if fmt == "safetensors":
        safetensors.numpy.save_file({k: v.numpy() for k, v in state.items()},
                                    str(root / "model.safetensors"))
    else:
        torch.save(state, root / "pytorch_model.bin")
    return state


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hugging_face_encodec_snapshot_decodes_as_in_jax(tmp_path, fmt):
    state = _hf_snapshot(tmp_path / "hf", fmt)
    n_q = len({k.split(".")[2] for k in state if k.startswith("quantizer.")})
    loaded = loaders.load_compression_model(str(tmp_path / "hf"), device="cpu")
    assert (loaded.sample_rate, loaded.frame_rate, loaded.num_codebooks,
            loaded.cardinality) == (32000, 25, n_q, 256)
    jm, jv = jax_loaders.load_compression_model(str(tmp_path / "hf"))
    codes = _codes(n_q, 256)
    want = np.asarray(jm.decode(jv, jax.numpy.asarray(codes)))
    got = loaded.decode(torch.from_numpy(codes), device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **WAV_TOL)
    # the port's writer gives back Hugging Face's keys and tensors
    written = loaders.hf_encodec_state_dict(loaded)
    assert written.keys() == state.keys()
    for key, value in state.items():
        torch.testing.assert_close(written[key], value, rtol=0, atol=0)


def test_hf_snapshot_written_by_the_port_round_trips(tmp_path):
    """A plain-weight port codec written as a weight-normed Hugging Face
    snapshot by the port's own numpy writer decodes as before."""
    codec = _perturbed(builders.get_debug_compression_model(device="cpu",
                                                            seed=6), seed=6)
    cfg = dict(HF_CFG, model_type="encodec", upsampling_ratios=[10, 8, 16],
               codebook_size=400, num_lstm_layers=0, use_conv_shortcut=False,
               use_causal_conv=False)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    st.save_file(loaders.hf_encodec_state_dict(codec),
                 tmp_path / "model.safetensors")
    loaded = loaders.load_compression_model(str(tmp_path), device="cpu")
    codes = torch.from_numpy(_codes(4, 400))
    np.testing.assert_allclose(loaded.decode(codes, device="cpu").numpy(),
                               codec.decode(codes, device="cpu").numpy(),
                               atol=1e-5, rtol=0)


def test_mert_reads_a_safetensors_only_snapshot(tmp_path):
    torch.manual_seed(2)
    port = _perturbed(mert.MERTModel(**TINY_MERT), seed=2)
    state = _hf_state(port, "new")
    (tmp_path / "bin").mkdir()
    (tmp_path / "st").mkdir()
    torch.save(state, tmp_path / "bin" / "pytorch_model.bin")
    safetensors.torch.save_file(state, str(tmp_path / "st" / "model.safetensors"))
    from_bin = mert.load_mert(tmp_path / "bin")
    from_st = mert.load_mert(tmp_path / "st")
    for key, value in from_bin.state_dict().items():
        assert torch.equal(from_st.state_dict()[key], value), key


@pytest.mark.parametrize("solver", ["musicgen", "diffusion", "jasco"])
def test_solvers_take_a_codec_package_path(tmp_path, solver):
    codec = builders.get_debug_compression_model(device="cpu", seed=8)
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    cfg = {"solver": solver, "seed": 0, "sample_rate": 32000,
           "compression_model_checkpoint": str(tmp_path)}
    if solver == "diffusion":
        cfg["diffusion_unet"] = dict(hidden=8, depth=2, growth=2.0, kernel=4,
                                     stride=2, norm_groups=4, codec_dim=32)
    built = get_solver(cfg, device="cpu")
    frozen = {"musicgen": "compression_model", "diffusion": "codec",
              "jasco": "compression_model"}[solver]
    got = getattr(built, frozen)
    assert not any(p.requires_grad for p in got.parameters())
    for key, value in codec.state_dict().items():
        assert torch.equal(got.state_dict()[key], value), key
    wav = np.random.RandomState(0).randn(2, 1, 12800).astype(np.float32) * 0.1
    if solver == "musicgen":
        from tests.test_torch_train import _fake_batch
        metrics = built.run_step(0, _fake_batch(), {})
        assert np.isfinite(metrics["ce"].item())
    else:
        assert np.isfinite(built.run_step(0, wav, {})["loss"].item())


# ------------------------------------------------------------ safetensors

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U8": np.uint8, "BOOL": np.bool_}


@pytest.mark.parametrize("name", list(DTYPES) + ["BF16"])
def test_safetensors_reader_matches_the_package(tmp_path, name):
    rs = np.random.RandomState(len(name))
    path = tmp_path / "t.safetensors"
    if name == "BF16":
        tensors = {"a": torch.randn(3, 5, generator=torch.Generator()
                                    .manual_seed(0)).bfloat16(),
                   "b": torch.zeros(0, 2, dtype=torch.bfloat16)}
        safetensors.torch.save_file(tensors, str(path),
                                    metadata={"format": "pt"})
        want = safetensors.torch.load_file(str(path))
    else:
        dtype = DTYPES[name]
        tensors = {"a": (rs.randn(4, 3, 2) * 50).astype(dtype),
                   "b": (rs.randn(7) > 0).astype(dtype),
                   "scalar": np.asarray(rs.randn() * 9, dtype)}
        safetensors.numpy.save_file(tensors, str(path),
                                    metadata={"format": "np"})
        want = {k: torch.from_numpy(v)
                for k, v in safetensors.numpy.load_file(str(path)).items()}
    got = st.load_file(path)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value)
    # the port's writer, read back by the package
    st.save_file(got, tmp_path / "ours.safetensors")
    back = safetensors.torch.load_file(str(tmp_path / "ours.safetensors"))
    for key, value in want.items():
        assert torch.equal(back[key], value)


def _raw(header: dict, buffer: bytes, length=None) -> bytes:
    text = json.dumps(header).encode()
    n = len(text) if length is None else length
    return n.to_bytes(8, "little") + text + buffer


@pytest.mark.parametrize("fault", ["truncated", "header_past_end", "overlap",
                                   "gap", "shape", "not_json"])
def test_safetensors_reader_refuses_a_bad_layout(tmp_path, fault):
    good = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
            "b": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}}
    buffer = bytes(12)
    raw = {
        "truncated": _raw(good, buffer)[:-3],
        "header_past_end": _raw(good, buffer, length=10_000),
        "overlap": _raw({**good, "b": dict(good["b"], data_offsets=[4, 8])},
                        buffer[:8]),
        "gap": _raw({**good, "b": dict(good["b"], data_offsets=[12, 16])},
                    bytes(16)),
        "shape": _raw({**good, "b": dict(good["b"], shape=[2])}, buffer),
        "not_json": (5).to_bytes(8, "little") + b"{oops" + buffer,
    }[fault]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="safetensors"):
        st.load_file(path)
    with pytest.raises(Exception):
        safetensors.numpy.load_file(str(path))
