"""Melody-conditioned MusicGen sweep
(`grids/musicgen/musicgen_melody_32khz.py`): chroma prepended to the
sequence, with and without chroma dropout."""
from .musicgen_base_32khz import scale
from ._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})
    chroma = {
        "conditioners.self_wav.model": "chroma_stem",
        "conditioners.self_wav.chroma_stem.sample_rate": 32000,
        "conditioners.self_wav.chroma_stem.n_chroma": 12,
        "conditioners.self_wav.chroma_stem.duration": 30,
        "fuser.prepend": ["self_wav"],
    }
    launcher.bind_(chroma, {"fsdp.use": True})
    drop = {"attribute_dropouts.args.active_on_eval": False,
            "attribute_dropouts.self_wav": 0.5}

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"))
        sub(scale("small"), drop)
    launcher.tpu_(chips=64, label="v5e-64")
    with launcher.job_array():
        launcher.bind()(scale("medium"), drop,
                        {"optim.optimizer": "adamw", "optim.lr": 1.0e-4})
