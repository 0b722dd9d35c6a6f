"""MusicGen 32 kHz base sweep (`grids/musicgen/musicgen_base_32khz.py`):
small/medium/large text-to-music over increasing device counts."""
from ...models.presets import MODEL_SCALES
from ._explorers import LMExplorer


def scale(name: str) -> dict:
    return {f"transformer_lm.{k}": v for k, v in MODEL_SCALES[name].items()}


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    # replace with the desired music dataset manifest
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})

    fsdp = {"fsdp.use": True}
    cfg_low = {"classifier_free_guidance.training_dropout": 0.2}
    wd_low = {"conditioners.description.t5.word_dropout": 0.2}
    adam = {"optim.optimizer": "adamw", "optim.lr": 1.0e-4}

    launcher.bind_(fsdp)

    launcher.tpu_(chips=32, topology="4x8", label="v5e-32")
    with launcher.job_array():
        launcher.bind()(scale("small"))

    launcher.tpu_(chips=64, topology="8x8", label="v5e-64")
    with launcher.job_array():
        launcher.bind()(scale("medium"), adam)

    launcher.tpu_(chips=128, topology="8x16", label="v5e-128")
    with launcher.job_array():
        launcher.bind()(scale("large"), cfg_low, wd_low, adam,
                        {"optim.max_norm": 3})
