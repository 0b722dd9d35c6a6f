"""The port's data plane against the JAX package on the CPU: WAV reads,
writes and metadata, loudness and normalisation, the libav round trips,
manifests, every dataset type, the loader with worker processes, the disk
caches and the sample manager, on files of 2 s at 16, 22.05, 32 and
44.1 kHz written here.

Tolerances: decoded audio, written bytes, manifests, infos, sample ids and
cached arrays equal; a segment that is not resampled equal; a resampled
one (the JAX resampling op against the port's torch one) atol 1e-5;
loudness and normalised audio atol 1e-5; the mixing augmentation's audio
atol 1e-6 (numpy in both, the same draws)."""
import gzip
import json
import pickle
import random
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiocraft_tpu.data import audio as jaudio
from audiocraft_tpu.data import audio_dataset as jad
from audiocraft_tpu.data import audio_utils as jutils
from audiocraft_tpu.data import info_audio_dataset as jinfo
from audiocraft_tpu.data import jasco_dataset as jjasco
from audiocraft_tpu.data import loader as jloader
from audiocraft_tpu.data import music_dataset as jmusic
from audiocraft_tpu.data import sound_dataset as jsound
from audiocraft_tpu.data import zip as jzip
from audiocraft_tpu.utils import cache as jcache
from audiocraft_tpu.utils.samples import manager as jmanager
from audiocraft_tpu_torch.data import _native, audio, audio_dataset
from audiocraft_tpu_torch.data import audio_utils, info_audio_dataset
from audiocraft_tpu_torch.data import jasco_dataset, loader, music_dataset
from audiocraft_tpu_torch.data import sound_dataset, zip as pzip
from audiocraft_tpu_torch.utils import cache
from audiocraft_tpu_torch.utils.samples import manager

from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

FILES = [(16000, 1), (22050, 2), (44100, 2), (32000, 1)]
MUSIC = {"title": "T", "artist": "A", "key": "C major", "bpm": "120",
         "genre": "Rock", "moods": ["happy", "loud"], "keywords": "a, b",
         "name": "n", "instrument": "Piano"}


def _signal(sr: int, channels: int, seconds: float = 2.0, seed: int = 0):
    t = np.arange(int(seconds * sr)) / sr
    rs = np.random.RandomState(seed)
    wav = 0.3 * np.sin(2 * np.pi * (180 + 60 * seed) * t)[None] \
        * np.linspace(1, 0.5, channels)[:, None] \
        + 0.05 * rs.randn(channels, t.size)
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for i, (sr, ch) in enumerate(FILES):
        audio.audio_write(root / f"f{i}", _signal(sr, ch, seed=i), sr,
                          normalize=False, strategy="clip")
        (root / f"f{i}.json").write_text(json.dumps(
            {**MUSIC, "description": f"Track {i}. Calm.",
             "bpm": str(100 + i)}))
    audio_dataset.save_audio_meta(root / "data.jsonl",
                                  audio_dataset.find_audio_files(root))
    return root


def _wav_bytes(wav: np.ndarray, sr: int, bits: int, fmt: int) -> bytes:
    """A WAV of [C, T] in `bits` (fmt 1 integer PCM, 3 float)."""
    frames = wav.T
    if fmt == 3:
        data = frames.astype("<f4").tobytes()
    elif bits == 16:
        data = np.round(frames * 32767).astype("<i2").tobytes()
    elif bits == 32:
        data = np.round(frames * 2 ** 31 * 0.99).astype("<i4").tobytes()
    else:
        ints = np.round(frames * (2 ** 23 - 1)).astype("<i4").reshape(-1)
        data = b"".join(struct.pack("<i", v)[:3] for v in ints)
    ch = wav.shape[0]
    block = ch * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * block, block, bits)
            + b"data" + struct.pack("<I", len(data)) + data)


def _info(info):
    return info.sample_rate, info.duration, info.channels


@pytest.mark.parametrize("bits, fmt", [(16, 1), (24, 1), (32, 1), (32, 3)])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_read_info_and_write_equal_jax(tmp_path, bits, fmt, channels):
    wav = _signal(22050, channels, seconds=0.5)
    path = tmp_path / "x.wav"
    path.write_bytes(_wav_bytes(wav, 22050, bits, fmt))
    assert _info(audio.audio_info(path)) == _info(jaudio.audio_info(path))
    for seek, duration, pad in [(0.0, -1.0, False), (0.1, 0.2, False),
                                (0.4, 0.3, True), (0.4, 0.3, False)]:
        got, sr = audio.audio_read(path, seek, duration, pad)
        want, jsr = jaudio.audio_read(path, seek, duration, pad)
        assert sr == jsr == 22050 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert audio.audio_read(path, 0.4, 0.3, pad=True)[0].shape[-1] == 6615
    for strategy in ("peak", "rms", "clip", "loudness"):
        a = audio.audio_write(tmp_path / f"p_{strategy}", wav, 22050,
                              strategy=strategy)
        b = jaudio.audio_write(tmp_path / f"j_{strategy}", wav, 22050,
                               strategy=strategy)
        assert a.read_bytes() == b.read_bytes(), strategy


def test_loudness_and_normalisation_match_jax():
    for sr, ch in FILES:
        wav = _signal(sr, ch, seed=3)
        assert abs(audio_utils.measure_loudness(wav, sr)
                   - jutils.measure_loudness(wav, sr)) < 1e-5
        quiet = (wav * 1e-4).astype(np.float32)
        for x in (wav, quiet, wav[:, :100]):
            for kw in [dict(strategy="peak"), dict(strategy="rms"),
                       dict(strategy="loudness", loudness_compressor=True),
                       dict(strategy="loudness"), dict(strategy="clip"),
                       dict(strategy="peak", normalize=False)]:
                np.testing.assert_allclose(
                    audio_utils.normalize_audio(x, sample_rate=sr, **kw),
                    jutils.normalize_audio(x, sample_rate=sr, **kw),
                    atol=1e-5, err_msg=str(kw))
    x = np.array([-1.0, -0.5, 0.3, 1.0], np.float32)
    np.testing.assert_array_equal(audio_utils.i16_pcm(x), jutils.i16_pcm(x))
    for ints in (np.array([-32768, 5, 32767], np.int16),
                 np.array([-2 ** 31, 7, 2 ** 31 - 1], np.int32)):
        np.testing.assert_array_equal(audio_utils.f32_pcm(ints),
                                      jutils.f32_pcm(ints))


def test_libav_round_trips_match_jax(tmp_path):
    """mp3 and aac through the libav binding, as the JAX package's (both
    encoders are deterministic): equal audio, a straight-through gradient,
    and compressed files read back by both packages. Where libav cannot be
    built, asking for it raises and WAV still works."""
    wav = _signal(16000, 1, seconds=0.5, seed=1)[None].repeat(2, 0)
    if not _native.av_available():
        with pytest.raises(RuntimeError):
            audio_utils.get_mp3(torch.from_numpy(wav), 16000)
        return
    for port_fn, jax_fn in ((audio_utils.get_mp3, jutils.get_mp3),
                            (audio_utils.get_aac, jutils.get_aac)):
        x = torch.from_numpy(wav).requires_grad_(True)
        out = port_fn(x, 16000, "128k")
        np.testing.assert_array_equal(out.detach().numpy(),
                                      jax_fn(wav, 16000, "128k"))
        out.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(x))
    path = audio.audio_write(tmp_path / "c", wav[0], 16000, format="mp3")
    assert path.suffix == ".mp3"
    assert _info(audio.audio_info(path)) == _info(jaudio.audio_info(path))
    np.testing.assert_array_equal(audio.audio_read(path, 0.1, 0.2)[0],
                                  jaudio.audio_read(path, 0.1, 0.2)[0])


def test_manifests_read_across_packages(data_dir, tmp_path):
    port = audio_dataset.find_audio_files(data_dir, workers=2)
    jax_meta = jad.find_audio_files(data_dir)
    assert [m.to_dict() for m in port] == [m.to_dict() for m in jax_meta]
    for name in ("m.jsonl", "m.jsonl.gz"):
        audio_dataset.save_audio_meta(tmp_path / f"p_{name}", port)
        jad.save_audio_meta(tmp_path / f"j_{name}", jax_meta)
        assert [m.to_dict() for m in jad.load_audio_meta(
            tmp_path / f"p_{name}")] == [m.to_dict() for m in port]
        assert [m.to_dict() for m in audio_dataset.load_audio_meta(
            tmp_path / f"j_{name}")] == [m.to_dict() for m in port]
    opener = gzip.open
    with opener(tmp_path / "p_m.jsonl.gz", "rb") as f:
        assert len(f.readlines()) == len(FILES)
    zipped = audio_dataset.AudioMeta.from_dict(
        {"path": "a.wav", "duration": 1.0, "sample_rate": 8000,
         "info_path": "x.zip:a.json"})
    assert zipped.info_path == pzip.PathInZip("x.zip:a.json")
    assert zipped.to_dict() == jad.AudioMeta.from_dict(
        zipped.to_dict()).to_dict()
    audio_dataset.main([str(data_dir), str(tmp_path / "cli.jsonl")])
    assert (tmp_path / "cli.jsonl").read_text() == \
        (data_dir / "data.jsonl").read_text()


def test_zip_members_read_as_jax(tmp_path):
    import zipfile
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as zf:
        zf.writestr("info.json", '{"x": 1}')
    path = f"{tmp_path / 'a.zip'}:info.json"
    with pzip.open_file_in_zip(pzip.PathInZip(path)) as f, \
            jzip.open_file_in_zip(jzip.PathInZip(path)) as g:
        assert f.read() == g.read()
    pzip.set_zip_cache_size(4)
    assert str(pzip.PathInZip(path)) == path


KW = dict(segment_duration=0.5, num_samples=6, sample_rate=32000,
          channels=1, shuffle=True, return_info=True, min_segment_ratio=0.5)
SEGMENT_FIELDS = ("seek_time", "n_frames", "total_frames", "sample_rate",
                  "channels")


def _check_item(got, want, resampled_from: int):
    (wav, info), (jwav, jinfo) = got, want
    assert info.meta.to_dict() == jinfo.meta.to_dict()
    for field in SEGMENT_FIELDS:
        assert getattr(info, field) == getattr(jinfo, field), field
    if info.meta.sample_rate == resampled_from:
        np.testing.assert_array_equal(wav.numpy(), np.asarray(jwav))
    else:
        np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=1e-5)


@pytest.mark.parametrize("kind", ["audio", "info", "music"])
@pytest.mark.parametrize("sampling", [
    dict(), dict(sample_on_weight=False, sample_on_duration=False),
    dict(sample_on_weight=False, sample_on_duration=False,
         permutation_on_files=True), dict(shuffle=False),
    dict(segment_duration=None)])
def test_datasets_match_jax(data_dir, kind, sampling):
    classes = {"audio": (audio_dataset.AudioDataset, jad.AudioDataset),
               "info": (info_audio_dataset.InfoAudioDataset,
                        jinfo.InfoAudioDataset),
               "music": (music_dataset.MusicDataset, jmusic.MusicDataset)}
    port_cls, jax_cls = classes[kind]
    kw = {**KW, **sampling}
    ds = port_cls.from_meta(data_dir, **kw)
    jds = jax_cls.from_meta(data_dir, **kw)
    for epoch in (0, 3):
        ds.start_epoch(epoch)
        jds.start_epoch(epoch)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            _check_item(got, want, 32000)
            if kind == "music":
                for field in ("title", "artist", "key", "bpm", "genre",
                              "moods", "keywords", "description", "name",
                              "instrument"):
                    assert getattr(got[1], field) == \
                        getattr(want[1], field), field
                assert got[1].self_wav.wav.data_ptr() == got[0].data_ptr()
                text = got[1].to_condition_attributes().text
                jtext = want[1].to_condition_attributes().text
                assert text.pop("meta").to_dict() == jtext.pop("meta").to_dict()
                assert text == jtext
    batch = ds.collater([ds[0], ds[1]])
    jbatch = jds.collater([jds[0], jds[1]])
    np.testing.assert_allclose(batch[0].numpy(), np.asarray(jbatch[0]),
                               atol=1e-5)
    assert [i.total_frames for i in batch[1]] == \
        [i.total_frames for i in jbatch[1]]


def test_music_text_augmentation_with_injected_draws(data_dir, tmp_path,
                                                     monkeypatch):
    """Paraphrases and merged tags: the JAX package draws from Python's
    global `random`; given the generator the port seeds for the item, it
    draws the same."""
    source = {str(data_dir / f"f{i}.json"): [f"para {i} a", f"para {i} b"]
              for i in range(len(FILES))}
    (tmp_path / "para.json").write_text(json.dumps(source))
    kw = dict(KW, merge_text_p=0.7, drop_desc_p=0.3, drop_other_p=0.6,
              paraphrase_source=str(tmp_path / "para.json"), paraphrase_p=0.5)
    ds = music_dataset.MusicDataset.from_meta(data_dir, **kw)
    jds = jmusic.MusicDataset.from_meta(data_dir, **kw)
    ds.start_epoch(2)
    jds.start_epoch(2)
    descriptions = set()
    for i in range(len(ds)):
        monkeypatch.setattr(jmusic, "random",
                            random.Random(ds._item_seed(i)))
        got, want = ds[i][1], jds[i][1]
        assert got.description == want.description
        descriptions.add(got.description)
    assert len(descriptions) > 2


def test_sound_dataset_and_mixing_match_jax(data_dir, monkeypatch):
    kw = dict(KW, info_fields_required=False)
    ds = sound_dataset.SoundDataset.from_meta(data_dir, **kw)
    jds = jsound.SoundDataset.from_meta(data_dir, **kw)
    ds.start_epoch(1)
    jds.start_epoch(1)
    items = [ds[i] for i in range(4)]
    jitems = [jds[i] for i in range(4)]
    for got, want in zip(items, jitems):
        _check_item(got, want, 32000)
        assert got[1].description == want[1].description
    wav, infos = ds.collater(items)
    jwav, jinfos = jds.collater(jitems)
    for aug_p in (0.0, 1.0):
        rng_seed, np_seed = 5, 6
        monkeypatch.setattr(jsound, "random", random.Random(rng_seed))
        np.random.seed(np_seed)
        want_wav, want_infos = jsound.mix_samples(
            np.asarray(jwav), jinfos, aug_p, 0.5, -5, 5, 0.5)
        got_wav, got_infos = sound_dataset.mix_samples(
            wav, infos, aug_p, 0.5, -5, 5, 0.5,
            rng=random.Random(rng_seed), np_rng=np.random.RandomState(np_seed))
        np.testing.assert_allclose(got_wav.numpy(), want_wav, atol=1e-6)
        assert [i.description for i in got_infos] == \
            [i.description for i in want_infos]


def test_jasco_dataset_matches_jax(data_dir, tmp_path):
    stems = [f"f{i}" for i in range(len(FILES))]
    chords = {s: [("C", 0.0), ("G", 0.4), ("A:min", 0.9), ("F", 1.5)]
              for s in stems}
    mapping = {"N": 0, "C": 1, "G": 2, "A:min": 3, "F": 4}
    for name, obj in (("chords_per_track.pkl", chords),
                      ("chord_to_index_mapping.pkl", mapping)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f)
    salience = tmp_path / "salience"
    salience.mkdir()
    (salience / "tracks.txt").write_text(
        "\n".join(f"{s}.wav" for s in stems[:2]))
    rs = np.random.RandomState(0)
    for s in stems[:2]:
        np.savez(salience / f"{s}_multif0_salience.npz",
                 salience=rs.rand(60, 200).astype(np.float32))
    kw = dict(KW, compression_model_framerate=50,
              chords_path=str(tmp_path / "chords_per_track.pkl"),
              chords_mapping_path=str(tmp_path / "chord_to_index_mapping.pkl"),
              melody_kwargs=dict(latent_fr=50, segment_duration=0.5,
                                 chroma_root=str(salience)))
    ds = jasco_dataset.JascoDataset.from_meta(data_dir, **kw)
    jds = jjasco.JascoDataset.from_meta(data_dir, **kw)
    ds.start_epoch(1)
    jds.start_epoch(1)
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        _check_item(got, want, 32000)
        np.testing.assert_array_equal(got[1].chords.frame_chords,
                                      want[1].chords.frame_chords)
        np.testing.assert_array_equal(got[1].melody.melody,
                                      want[1].melody.melody)
    assert set(got[1].to_condition_attributes().symbolic) == \
        {"chords", "melody"}


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax_with_workers(data_dir, workers):
    kw = dict(KW, num_samples=8)
    ds = music_dataset.MusicDataset.from_meta(data_dir, **kw)
    jds = jmusic.MusicDataset.from_meta(data_dir, **kw)
    port = loader.DataLoader(ds, batch_size=3, num_workers=workers,
                             timeout=60)
    jax_loader = jloader.DataLoader(jds, batch_size=3, num_workers=0)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        batches = list(port)
        assert len(batches) == len(port) == 2
        for (wav, infos), (jwav, jinfos) in zip(batches, jax_loader):
            np.testing.assert_allclose(wav.numpy(), np.asarray(jwav),
                                       atol=1e-5)
            assert [(i.meta.path, i.seek_time, i.description) for i in infos] \
                == [(i.meta.path, i.seek_time, i.description) for i in jinfos]
            assert all(i.self_wav.wav.shape == (1, 1, 16000) for i in infos)
            if workers == 0:
                assert infos[1].self_wav.wav.data_ptr() == wav[1].data_ptr()


_LOADER_EXIT_SCRIPT = """
import multiprocessing
import sys
sys.path.insert(0, {root!r})
import torch
from torch.utils.data import TensorDataset, default_collate
from audiocraft_tpu_torch.data import loader

PENDING = []


def main():
    data = loader.DataLoader(TensorDataset(torch.arange(16.)), batch_size=4,
                             num_workers=2, collate_fn=default_collate,
                             timeout=60)
    assert [b[0].tolist() for b in data][1] == [4., 5., 6., 7.]
    loader.shutdown()
    assert multiprocessing.active_children() == []
    PENDING.append(iter(data))  # a pass left unfinished at exit
    assert next(PENDING[0])[0].tolist() == [0., 1., 2., 3.]


if __name__ == "__main__":
    main()
"""


def _session_processes(sid: int):
    found = []
    for entry in Path("/proc").iterdir():
        try:
            stat = (entry / "stat").read_text()
            if int(stat[stat.rindex(")") + 2:].split()[3]) == sid:
                found.append((entry.name, stat))
        except (OSError, ValueError):
            pass  # not a process, or one that ended while being read
    return found


def test_loader_leaves_no_process_after_exit(tmp_path):
    """A script whose workers, fork server and resource tracker are still
    up when it ends leaves none of them behind, and `shutdown` ends them
    in the middle of a run (a later pass starts them again)."""
    script = tmp_path / "loader_exit.py"
    script.write_text(_LOADER_EXIT_SCRIPT.format(
        root=str(Path(__file__).resolve().parents[1])))
    # the script leads a session of its own, so what is left of that
    # session once it has ended is what it left running
    proc = subprocess.Popen([sys.executable, str(script)],
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    _, err = proc.communicate(timeout=120)
    left = _session_processes(proc.pid)
    assert proc.returncode == 0, err
    assert left == []


def test_batch_cache_read_across_packages(tmp_path):
    rs = np.random.RandomState(0)
    content = {"codes": rs.randint(0, 64, (2, 4, 5)),
               "tokenized": {"description": (rs.randint(0, 9, (2, 3)),
                                             rs.rand(2, 3) > 0.5)},
               "padding_mask": rs.rand(2, 5) > 0.3}
    port_writer = cache.CachedBatchWriter(tmp_path / "port")
    jax_writer = jcache.CachedBatchWriter(tmp_path / "jax")
    for writer in (port_writer, jax_writer):
        writer.start_epoch(1)
        for _ in range(3):
            writer.save(content if writer is jax_writer else {
                "codes": torch.from_numpy(content["codes"]),
                "tokenized": content["tokenized"],
                "padding_mask": torch.from_numpy(content["padding_mask"])})
    for folder, reader in ((tmp_path / "port", jcache.CachedBatchLoader),
                           (tmp_path / "jax", cache.CachedBatchLoader)):
        read = reader(folder, batch_size=2, num_workers=2)
        read.start_epoch(1)
        batches = list(read)
        assert len(batches) == len(read) == 3
        (got,) = batches[0]
        np.testing.assert_array_equal(got["codes"], content["codes"])
        np.testing.assert_array_equal(got["padding_mask"],
                                      content["padding_mask"])
        for a, b in zip(got["tokenized"]["description"],
                        content["tokenized"]["description"]):
            np.testing.assert_array_equal(a, b)


def test_embedding_cache_read_across_packages(tmp_path):
    paths = [tmp_path / "a.wav", tmp_path / "b.wav"]
    full = {p: np.random.RandomState(i).rand(7, 3).astype(np.float32)
            for i, p in enumerate(paths)}

    def extract(embed, x, idx):
        return embed[x:x + 2]

    port = cache.EmbeddingCache(tmp_path / "c",
                                lambda p, x, i: torch.from_numpy(full[p]),
                                extract)
    got = port.get_embed_from_cache(paths, 1)
    np.testing.assert_array_equal(got, np.stack([full[p][1:3] for p in paths]))

    def no_compute(*args):
        raise AssertionError("computed instead of read from the cache")

    jax_side = jcache.EmbeddingCache(tmp_path / "c", no_compute, extract)
    jax_side.populate_embed_cache(paths, 2)
    np.testing.assert_array_equal(jax_side.get_embed_from_cache(paths, 2),
                                  np.stack([full[p][2:4] for p in paths]))
    port.populate_embed_cache(paths, 4)
    port._compute_embed_fn = no_compute
    np.testing.assert_array_equal(port.get_embed_from_cache(paths, 4),
                                  np.stack([full[p][4:6] for p in paths]))


@pytest.mark.parametrize("reuse", [False, True])
def test_sample_manager_writes_what_jax_writes(tmp_path, reuse):
    from types import SimpleNamespace
    cfg = {"sample_rate": 16000, "generate": {"audio": {"strategy": "peak"}}}
    rs = np.random.RandomState(0)
    gen = (0.2 * rs.randn(2, 1, 800)).astype(np.float32)
    prompt = (0.2 * rs.randn(2, 1, 200)).astype(np.float32)
    truth = (0.2 * rs.randn(2, 1, 800)).astype(np.float32)
    conds = [{"description": "Happy rock!"}, {"description": "jazz, slow"}]
    roots = {}
    for name, module, to in (("port", manager, torch.from_numpy),
                             ("jax", jmanager, np.asarray)):
        roots[name] = tmp_path / name
        m = module.SampleManager(SimpleNamespace(folder=roots[name], cfg=cfg),
                                 map_reference_to_sample_id=reuse)
        m.add_samples(to(gen), 3, conditioning=conds, prompt_wavs=to(prompt),
                      ground_truth_wavs=to(truth), generation_args={"k": 1})
    files = {name: sorted(p.relative_to(root) for p in root.rglob("*")
                          if p.is_file())
             for name, root in roots.items()}
    assert files["port"] == files["jax"] and len(files["port"]) == 8
    for rel in files["port"]:
        a = (roots["port"] / rel).read_bytes()
        b = (roots["jax"] / rel).read_bytes()
        if rel.suffix == ".json":
            a, b = (json.loads(x.decode().replace(str(r), "ROOT"))
                    for x, r in ((a, roots["port"]), (b, roots["jax"])))
        assert a == b, rel
    read = manager.SampleManager(SimpleNamespace(folder=roots["jax"], cfg=cfg))
    jread = jmanager.SampleManager(SimpleNamespace(folder=roots["port"],
                                                   cfg=cfg))
    assert {s.id for s in read.get_samples()} == \
        {s.id for s in jread.get_samples()}
    assert read.latest_epoch == 3 and len(read.get_samples(
        exclude_prompted=True)) == 0
    assert manager.slugify("Héllo, World!") == jmanager.slugify("Héllo, World!")
