"""The port's grids (`audiocraft_tpu_torch/grids/`), assets and notebook
helpers against the JAX package's:

- every grid of `tests/test_grids.py::ALL_GRIDS` collects the same jobs in
  both packages: overrides, chips, topology, label, job array, signature
  and train argv;
- `list_grids()` names the same grids;
- the CLI prints the same plan, and `--run` hands `train.main` each job's
  argv followed by the `-o` overrides, which win over the job's own in the
  composed config;
- `load_chord_mapping` and `generate_melody_clip` (written as WAV) give the
  JAX package's mapping and samples; `display_audio` renders one player per
  item through a stub `IPython.display`.

Everything is exact: the same declarations, the same numpy synthesis and
the same 16-bit WAV writer path.
"""
import sys
import types

import numpy as np
import pytest
import torch

from audiocraft_tpu.data import audio as jaudio
from audiocraft_tpu.grids import __main__ as jcli
from audiocraft_tpu.utils import assets as jassets
from audiocraft_tpu.utils import notebook as jnotebook
from audiocraft_tpu_torch import train
from audiocraft_tpu_torch.data import audio
from audiocraft_tpu_torch.grids import BaseExplorer, Launcher
from audiocraft_tpu_torch.grids import __main__ as cli
from audiocraft_tpu_torch.utils import assets, notebook
from tests.test_grids import ALL_GRIDS


def _jobs(explorer):
    return [(j.overrides, j.chips, j.topology, j.label, j.array_id, j.sig,
             j.argv()) for j in explorer.collect()]


@pytest.mark.parametrize("name", ALL_GRIDS)
def test_grid_collects_the_jax_jobs(name):
    port, jax_explorer = cli.find_explorer(name), jcli.find_explorer(name)
    assert isinstance(port, BaseExplorer)
    assert type(port).__name__ == type(jax_explorer).__name__
    assert port.stages() == jax_explorer.stages()
    assert port.get_grid_metrics() == jax_explorer.get_grid_metrics()
    jobs = _jobs(port)
    assert jobs and jobs == _jobs(jax_explorer)
    assert all(len(sig) == 8 for *_, sig, _ in jobs)


def test_list_grids_and_launcher_match_jax():
    assert cli.list_grids() == jcli.list_grids()
    assert set(ALL_GRIDS) <= set(cli.list_grids())
    launcher = Launcher()
    launcher.bind_(solver="musicgen", **{"optim.lr": 1e-4})
    child = launcher.bind({"fsdp": {"use": True}}).slurm_(gpus=4,
                                                          label="x")
    job = child()
    assert job.overrides == {"solver": "musicgen", "optim.lr": 1e-4,
                             "fsdp.use": True}
    assert (job.chips, job.label) == (4, "x")
    assert launcher().chips == 8
    with pytest.raises(SystemExit, match="unknown grid"):
        cli.find_explorer("musicgen.nope")


def test_cli_plan_matches_jax(capsys):
    argv = ["musicgen.musicgen_pretrained_32khz_eval", "--max-jobs", "2"]
    cli.main(argv)
    port = capsys.readouterr().out
    jcli.main(argv)
    assert port == capsys.readouterr().out
    assert "2 job(s), stages ['evaluate']" in port


def test_cli_run_hands_train_main_the_job_then_the_overrides(monkeypatch,
                                                             tmp_path):
    calls = []
    monkeypatch.setattr(train, "main", calls.append)
    extra = ["continue_from=/ckpt/checkpoint.th", "device=cpu"]
    jobs = cli.main(["musicgen.musicgen_pretrained_32khz_eval", "--run",
                     "--max-jobs", "1"] + [a for x in extra
                                           for a in ("-o", x)])
    assert calls == [jobs[0].argv() + extra]
    # the later override wins in the composed config
    cfg, delta = train.compose(calls[0])
    assert cfg["continue_from"] == delta["continue_from"] == \
        "/ckpt/checkpoint.th"
    assert cfg["execute_only"] == "evaluate"
    assert all(cfg["evaluate"]["metrics"][k] for k in (
        "fad", "kld", "text_consistency", "chroma_cosine"))


def test_chord_mapping_matches_jax(monkeypatch, tmp_path):
    assert assets.chord_mapping_path() == jassets.chord_mapping_path()
    assert assets.load_chord_mapping() == jassets.load_chord_mapping()
    monkeypatch.setenv("AUDIOCRAFT_ASSETS_DIR", str(tmp_path))
    assert assets.assets_root() == tmp_path == jassets.assets_root()


def test_melody_clip_matches_jax(tmp_path):
    port = assets.generate_melody_clip(tmp_path / "port.wav", duration=2.0)
    want = jassets.generate_melody_clip(tmp_path / "jax.wav", duration=2.0)
    got, sr = audio.audio_read(port)
    ref, jsr = jaudio.audio_read(want)
    assert sr == jsr == 32000 and got.shape == (1, 64000)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert port.read_bytes() == want.read_bytes()


def test_display_audio_with_a_stub_ipython(monkeypatch):
    shown = []
    display = types.ModuleType("IPython.display")
    display.Audio = lambda data, rate: ("audio", np.asarray(data).shape, rate)
    display.display = shown.append
    ipython = types.ModuleType("IPython")
    ipython.display = display
    monkeypatch.setitem(sys.modules, "IPython", ipython)
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    samples = torch.zeros(2, 1, 80).requires_grad_()
    notebook.display_audio(samples, 16000)
    notebook.display_audio(samples[0].detach().numpy(), 16000)
    jnotebook.display_audio(samples.detach().numpy(), 16000)
    assert shown == [("audio", (1, 80), 16000)] * 5
