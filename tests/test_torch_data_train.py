"""The port's trainers fed from a `datasource` against the JAX package on the
CPU, at small sizes: every solver's loaders (their batches equal the JAX
package's `get_audio_datasets`) and a train step from them, the MusicGen
batch cache and the chroma embedding cache read across packages, the
generate stages through the sample manager, an exported LM package read by
the JAX package's converters, and `train.main` with the JAX package's
experiment signature.

Tolerances: resampled batches atol 1e-5 (the JAX resampling op against the
port's torch one), others equal; cached codes equal; the exported LM's
logits atol 1e-4 / rtol 1e-4 (f32, sums in another order); chroma one-hots
agree on at least 99 % of frames (an argmax over near-equal bins may fall
either way)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu import train as jtrain
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.solvers import builders as jsolver_builders
from audiocraft_tpu.utils import cache as jcache
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch import train
from audiocraft_tpu_torch.config import load_config
from audiocraft_tpu_torch.data import audio, audio_dataset
from audiocraft_tpu_torch.models import loaders
from audiocraft_tpu_torch.modules.conditioners import (ChromaStemConditioner,
                                                       ConditioningAttributes,
                                                       WavCondition)
from audiocraft_tpu_torch.solvers import get_solver
from audiocraft_tpu_torch.utils import cache
from audiocraft_tpu_torch.utils.export import export_lm

from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

TYPES = {"musicgen": "MUSIC", "audiogen": "SOUND", "magnet": "MUSIC",
         "compression": "AUDIO", "diffusion": "AUDIO", "jasco": "MUSIC",
         "watermarking": "AUDIO"}
SOLVER_CFG = {"musicgen": {}, "audiogen": {}, "magnet": {},
              "compression": {},
              "diffusion": {"diffusion_unet": dict(hidden=8, depth=2,
                                                   codec_dim=32)},
              "jasco": {}, "watermarking": {}}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """3 files of 2 s (32 kHz mono, 44.1 kHz stereo, 16 kHz mono) with
    music and sound sidecars, and their manifest."""
    root = tmp_path_factory.mktemp("train_data")
    rs = np.random.RandomState(0)
    for i, (sr, ch) in enumerate([(32000, 1), (44100, 2), (16000, 1)]):
        t = np.arange(2 * sr) / sr
        wav = 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t) \
            + 0.05 * rs.randn(ch, t.size)
        audio.audio_write(root / f"t{i}", wav.astype(np.float32), sr,
                          normalize=False, strategy="clip")
        (root / f"t{i}.json").write_text(json.dumps({
            "title": "T", "artist": "A", "key": "C", "bpm": 100 + i,
            "genre": "rock", "moods": ["calm"], "keywords": "a",
            "name": "n", "instrument": "mix",
            "description": ["a calm tune", "soft drums"][i % 2]}))
    audio_dataset.save_audio_meta(root / "data.jsonl",
                                  audio_dataset.find_audio_files(root))
    return root


def _cfg(name, data_dir, sample_rate=32000, **extra):
    cfg = {"solver": name, "seed": 0, "sample_rate": sample_rate,
           "channels": 1, "datasource": {"train": str(data_dir)},
           "dataset": {"batch_size": 2, "segment_duration": 1.0,
                       "num_workers": 0, "train": {"num_samples": 4},
                       "info_fields_required": False},
           **SOLVER_CFG[name]}
    for key, value in extra.items():
        cfg[key] = value
    return cfg


@pytest.mark.parametrize("name", list(TYPES))
def test_solvers_train_from_a_datasource(name, data_dir):
    """Each solver builds its loaders from `datasource` as the JAX package's
    builder does (same dataset type, same kept keys): the first batch
    equals the JAX loader's, and a train step on it is finite."""
    sample_rate = 16000 if name in ("audiogen", "watermarking") else 32000
    cfg = _cfg(name, data_dir, sample_rate)
    solver = get_solver(cfg, device="cpu")
    jloaders = jsolver_builders.get_audio_datasets(
        json.loads(json.dumps(cfg)),
        getattr(jsolver_builders.DatasetType, TYPES[name]))
    port_loader = solver.dataloaders["train"]
    assert type(port_loader.dataset).__name__ == \
        type(jloaders["train"].dataset).__name__
    port_loader.set_epoch(1)
    jloaders["train"].set_epoch(1)
    (wav, infos), (jwav, jinfos) = next(iter(port_loader)), \
        next(iter(jloaders["train"]))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=1e-5)
    assert [(i.meta.path, i.seek_time, i.n_frames) for i in infos] == \
        [(i.meta.path, i.seek_time, i.n_frames) for i in jinfos]
    solver.dataloaders = {"train": [(wav, infos)]}
    metrics = solver.run_one_stage("train")
    assert metrics and all(np.isfinite(v) for v in metrics.values())


def test_musicgen_batch_from_a_datasource_encodes_as_jax(data_dir):
    """The MusicGen solver's codes, tokenized descriptions and padding mask
    of its loader's first batch equal the JAX solver's preparation of the
    JAX loader's batch (the JAX debug codec carrying the port's weights);
    the train step on them is held against the JAX step in
    `test_torch_train.py`."""
    import types
    from audiocraft_tpu.models import builders as jbuilders
    from audiocraft_tpu.solvers import musicgen as jmg
    from tests.test_torch_mbd import _jax_codec
    cfg = _cfg("musicgen", data_dir)
    cfg["dataset"]["segment_duration"] = 1.5  # padded rows: a 2 s file
    cfg["dataset"]["train"]["num_samples"] = 6
    solver = get_solver(cfg, device="cpu")
    jloader = jsolver_builders.get_audio_datasets(
        json.loads(json.dumps(cfg)), jsolver_builders.DatasetType.MUSIC)
    jcodec, jvars = _jax_codec(solver.compression_model)
    jsolver = types.SimpleNamespace(
        compression_model=jcodec, compression_variables=jvars,
        model=jbuilders.get_debug_lm_model()[0])
    solver.dataloaders["train"].set_epoch(2)
    jloader["train"].set_epoch(2)
    for batch, jbatch in zip(solver.dataloaders["train"], jloader["train"]):
        codes, tokenized, padding = solver._prepare_tokens_and_attributes(
            batch, training=False)
        jcodes, jtokenized, jpadding = \
            jmg.MusicGenSolver._prepare_tokens_and_attributes(
                jsolver, jbatch, training=False)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(padding.numpy(), np.asarray(jpadding))
        for a, b in zip(tokenized["description"], jtokenized["description"]):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert not padding.all()


def _debug_solver(folder, data_dir, **cache_cfg):
    cfg = _cfg("musicgen", data_dir, folder=str(folder),
               optim={"epochs": 1, "updates_per_epoch": 2})
    if cache_cfg:
        cfg["cache"] = cache_cfg
    return get_solver(cfg, device="cpu")


def test_batch_cache_written_and_read_across_packages(tmp_path, data_dir):
    """`cache.write` stores each train batch's codes, tokenized conditions
    and padding mask in the JAX package's layout; the JAX loader reads
    them; a cache the JAX writer stores replays through `cache.path` in
    place of the train loader."""
    writer = _debug_solver(tmp_path / "w", data_dir,
                           path=str(tmp_path / "cache"), write=True)
    writer.dataloaders["train"].set_epoch(1)
    batch = next(iter(writer.dataloaders["train"]))
    codes, tokenized, padding = writer._prepare_tokens_and_attributes(
        batch, training=False)
    writer.run_one_stage("train")
    jloader = jcache.CachedBatchLoader(tmp_path / "cache", batch_size=2,
                                       num_workers=1)
    jloader.start_epoch(1)
    cached = [b[0] for b in jloader]
    assert len(cached) == 2
    np.testing.assert_array_equal(cached[0]["codes"], codes.numpy())
    np.testing.assert_array_equal(cached[0]["padding_mask"], padding.numpy())
    for a, b in zip(cached[0]["tokenized"]["description"],
                    tokenized["description"]):
        np.testing.assert_array_equal(a, b)

    jwriter = jcache.CachedBatchWriter(tmp_path / "jax_cache")
    jwriter.start_epoch(1)
    for content in cached:
        jwriter.save(content)
    reader = _debug_solver(tmp_path / "r", data_dir,
                           path=str(tmp_path / "jax_cache"))
    assert isinstance(reader.dataloaders["train"], cache.CachedBatchLoader)
    replayed = reader.run_one_stage("train")
    direct = _debug_solver(tmp_path / "d", data_dir)
    direct.dataloaders["train"] = [(c,) for c in cached]
    assert replayed == pytest.approx(direct.run_one_stage("train"))


def test_chroma_embedding_cache_matches_jax(tmp_path, data_dir):
    """The melody conditioner's `cache_path`: each file's whole chroma is
    computed once and cut at the row's seek time, as the JAX package's."""
    path = str(data_dir / "t1.wav")
    wav, sr = audio.audio_read(path, 0.5, 1.0)
    x = WavCondition(torch.from_numpy(wav[None]), torch.tensor([wav.shape[-1]]),
                     [sr], [path], [0.5])
    port = ChromaStemConditioner(16, sample_rate=32000, duration=1.0,
                                 cache_path=str(tmp_path / "p"), device="cpu")
    jax_side = jcond.ChromaStemConditioner(output_dim=16, sample_rate=32000,
                                           duration=1.0,
                                           cache_path=str(tmp_path / "j"))
    got = port.tokenize(x)
    want = jax_side.tokenize(jcond.WavCondition(
        wav[None], np.array([wav.shape[-1]]), [sr], [path], [0.5]))
    assert got["chroma"].shape == want["chroma"].shape
    agree = (got["chroma"].numpy().argmax(-1)
             == np.asarray(want["chroma"]).argmax(-1)).mean()
    assert agree >= 0.99
    assert len(list((tmp_path / "p" / "wav").iterdir())) == 1
    again = port.tokenize(x)  # from the disk cache
    assert torch.equal(again["chroma"], got["chroma"])


def test_generate_stages_store_samples(tmp_path, data_dir):
    """MusicGen (unprompted and prompted), compression, JASCO and MAGNeT
    (through MAGNeT's wrapper) generate stages write their samples and
    references through the sample manager."""
    cfg = _cfg("musicgen", data_dir, folder=str(tmp_path / "mg"),
               generate={"lm": {"gen_duration": 0.2, "use_sampling": False,
                                "prompted_samples": True,
                                "prompt_duration": 0.08}})
    cfg["datasource"]["generate"] = str(data_dir)
    solver = get_solver(cfg, device="cpu")
    assert solver.run_one_stage("generate") == {"generated_samples": 2}
    folder = tmp_path / "mg" / "samples"
    assert len(list((folder / "1").glob("*_unprompted_*.wav"))) == 2
    assert len(list((folder / "1").glob("*_prompted_*.wav"))) == 2
    assert len(list((folder / "1" / "prompt").glob("*.wav"))) == 2
    assert len(list((folder / "reference").glob("*.wav"))) == 2
    for name in ("compression", "jasco", "magnet"):
        cfg = _cfg(name, data_dir, folder=str(tmp_path / name),
                   generate={"lm": {"gen_duration": 0.48,
                                    "use_sampling": False}})
        cfg["datasource"]["generate"] = str(data_dir)
        solver = get_solver(cfg, device="cpu")
        assert solver.generate() == {"generated_samples": 2}
        assert len(list((tmp_path / name / "samples" / "1")
                        .glob("*.json"))) == 2


def test_exported_lm_gives_the_same_logits_in_jax(tmp_path, data_dir):
    """A trained solver's checkpoint, exported as a package, loads in the
    port (`loaders.load_lm_model`, the same weights) and through the JAX
    package's converters, whose logits equal the port model's."""
    lm_cfg = {"transformer_lm": dict(n_q=4, card=1024, dim=32, num_heads=2,
                                     num_layers=2, hidden_scale=2,
                                     causal=True, cross_attention=True),
              "conditioners": {"description": {
                  "model": "lut", "lut": {"n_bins": 64, "dim": 16,
                                          "tokenizer": "whitespace"}}},
              "fuser": {"cross": ["description"], "prepend": [], "sum": [],
                        "input_interpolate": []},
              "codebooks_pattern": {"modeling": "delay",
                                    "delay": {"delays": [0, 1, 2, 3]}}}
    cfg = _cfg("musicgen", data_dir, folder=str(tmp_path / "xp"),
               optim={"epochs": 1, "updates_per_epoch": 1}, **lm_cfg)
    solver = get_solver(cfg, device="cpu")
    solver.run_one_stage("train")
    solver.save_checkpoints()
    (tmp_path / "xp" / "config.json").write_text(json.dumps(cfg))
    package = export_lm(tmp_path / "xp" / "checkpoint.th",
                        tmp_path / "export" / "state_dict.bin")
    loaded, _ = loaders.load_lm_model(str(package.parent), device="cpu")
    for key, value in solver.model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    jmodel, params, jcfg = torch_port.load_lm_model_from_dir(package.parent)
    assert jcfg["transformer_lm"] == cfg["transformer_lm"]
    texts = [ConditioningAttributes(text={"description": "calm tune"}),
             ConditioningAttributes(text={"description": "drums"})]
    seq = np.random.RandomState(1).randint(0, 1025, (2, 4, 7))
    ct = jmodel.apply(params, jlm.tokenize_conditions(
        jmodel, [jcond.ConditioningAttributes(text=a.text) for a in texts]),
        method=jlm.LMModel.compute_conditions)
    want, _ = jmodel.apply(params, jnp.asarray(seq), ct)
    model = solver.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(seq), model.compute_conditions(
            model.condition_provider.tokenize(texts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_train_main_runs_two_updates_with_the_jax_signature(
        tmp_path, monkeypatch):
    """`python -m audiocraft_tpu_torch.train solver=musicgen/debug
    dset=audio/example device=cpu` for two updates: the experiment's
    folder is named by the JAX package's signature of the same overrides,
    and holds the config, the checkpoint and the generated samples."""
    monkeypatch.setenv("AUDIOCRAFT_DORA_DIR", str(tmp_path / "dora"))
    monkeypatch.chdir(os.path.dirname(os.path.dirname(__file__)))
    argv = ["solver=musicgen/debug", "dset=audio/example", "device=cpu",
            "optim.epochs=1", "optim.updates_per_epoch=2",
            "dataset.valid.num_samples=2", "dataset.evaluate.num_samples=2",
            "dataset.generate.num_samples=2", "generate.lm.gen_duration=0.2"]
    history = train.main(argv)
    assert history[0]["train"]["ce"] > 0
    assert np.isfinite(history[0]["valid"]["ce"])
    assert history[0]["generate"] == {"generated_samples": 2}
    (folder,) = (tmp_path / "dora" / "xps").iterdir()
    assert (folder / "checkpoint.th").exists()
    saved = json.loads((folder / "config.json").read_text())
    assert saved["datasource"]["train"] == "egs/example"

    class Stub:
        def __init__(self, cfg):
            self.cfg = cfg

        def run(self):
            return self.cfg["folder"]

    monkeypatch.setattr(jtrain, "get_solver", Stub)
    monkeypatch.setattr(jtrain, "init_seed_and_system", lambda cfg: None)
    monkeypatch.setattr(jtrain.distrib, "init", lambda: None)
    assert os.path.basename(jtrain.main(argv)) == folder.name
    cfg = load_config("solver/musicgen/debug")
    assert train.solver_device({"device": "tpu"}) == "cuda"
    assert train.solver_device(cfg) == "cuda"


def test_legacy_checkpoints_export_as_jax_does(tmp_path):
    """First-release training checkpoints (the codec under `ema.state`, the
    LM under `fsdp_best_state` or `best_state`, a config without the LM's
    card and n_q) become the packages the JAX package's legacy export
    writes: the same weights and the same config."""
    from audiocraft_tpu.utils import export_legacy as jlegacy
    from audiocraft_tpu_torch.utils import export_legacy
    weights = {"w": torch.arange(6.0).reshape(2, 3)}
    cfg = {"transformer_lm": {"dim": 8, "layer_drop": 0.1,
                              "spectral_norm_ff_iters": 2},
           "interleave_stereo_codebooks": {"use": True, "downsample": 2}}
    torch.save({"ema": {"state": {"model": weights}}, "xp.cfg": cfg},
               tmp_path / "codec.th")
    torch.save({"fsdp_best_state": {"model": weights},
                "best_state": {"model": {}}, "xp.cfg": cfg},
               tmp_path / "lm.th")
    for name, port_fn, jax_fn in (
            ("codec", export_legacy.export_encodec, jlegacy.export_encodec),
            ("lm", export_legacy.export_lm, jlegacy.export_lm)):
        got = torch.load(port_fn(tmp_path / f"{name}.th",
                                 tmp_path / "port" / f"{name}.th"),
                         weights_only=True)
        want = torch.load(jax_fn(tmp_path / f"{name}.th",
                                 tmp_path / "jax" / f"{name}.th"),
                          weights_only=True)
        assert got["xp.cfg"] == want["xp.cfg"] and got["exported"]
        assert torch.equal(got["best_state"]["w"], want["best_state"]["w"])
    assert got["xp.cfg"]["transformer_lm"] == {"dim": 8, "card": 2048,
                                               "n_q": 8}


def test_dataset_mappers_of_the_team_config(tmp_path, monkeypatch, data_dir):
    """A team config's `dataset_mappers` for the cluster rewrite every
    manifest path of the info datasets, as in the JAX package."""
    from audiocraft_tpu.environment import AudioCraftEnvironment as JaxEnv
    from audiocraft_tpu_torch.data.info_audio_dataset import InfoAudioDataset
    from audiocraft_tpu_torch.environment import AudioCraftEnvironment
    (tmp_path / "team.yaml").write_text(
        f"mapped:\n  dora_dir: {tmp_path / 'xps'}\n  dataset_mappers:\n"
        f"    '^/nowhere/': '{data_dir}/'\n  partitions:\n    global: p1\n")
    monkeypatch.setenv("AUDIOCRAFT_CONFIG", str(tmp_path / "team.yaml"))
    monkeypatch.setenv("AUDIOCRAFT_CLUSTER", "mapped")
    monkeypatch.delenv("AUDIOCRAFT_DORA_DIR", raising=False)
    AudioCraftEnvironment.reset()
    JaxEnv.reset()
    try:
        meta = audio_dataset.load_audio_meta(data_dir / "data.jsonl")
        for m in meta:
            m.path = m.path.replace(str(data_dir), "/nowhere")
        ds = InfoAudioDataset(meta, segment_duration=0.5, num_samples=2,
                              sample_rate=32000, channels=1, return_info=True)
        ds.start_epoch(0)
        assert ds[0][1].meta.path.startswith(str(data_dir))
        assert JaxEnv.apply_dataset_mappers("/nowhere/t0.wav") == \
            AudioCraftEnvironment.apply_dataset_mappers("/nowhere/t0.wav")
        assert AudioCraftEnvironment.get_dora_dir() == tmp_path / "xps"
        assert AudioCraftEnvironment.get_slurm_partitions() == "p1"
    finally:
        AudioCraftEnvironment.reset()
        JaxEnv.reset()
