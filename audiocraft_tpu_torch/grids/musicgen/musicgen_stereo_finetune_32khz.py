"""Stereo finetune sweep (`grids/musicgen/musicgen_stereo_finetune_32khz.py`):
continue from mono checkpoints with interleaved stereo codebooks (2x n_q)."""
from .musicgen_base_32khz import scale
from ._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.train": "egs/music_stereo/train",
                    "datasource.valid": "egs/music_stereo/valid"})
    stereo = {
        "channels": 2,
        "interleave_stereo_codebooks.use": True,
        "interleave_stereo_codebooks.per_timestep": False,
        "transformer_lm.n_q": 8,
        "codebooks_pattern.delay.delays": [0, 0, 1, 1, 2, 2, 3, 3],
    }
    launcher.bind_(stereo, {"fsdp.use": True,
                            "optim.optimizer": "adamw", "optim.lr": 1.0e-5})

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"), {"continue_from": "//pretrained/facebook/musicgen-small"})
    launcher.tpu_(chips=64, label="v5e-64")
    with launcher.job_array():
        launcher.bind()(scale("medium"),
                        {"continue_from": "//pretrained/facebook/musicgen-medium"})
