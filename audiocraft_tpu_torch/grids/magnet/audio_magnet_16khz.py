"""Audio-MAGNeT 16 kHz sound sweep (`grids/magnet/audio_magnet_16khz.py`)."""
from ..musicgen.musicgen_base_32khz import scale
from ..musicgen._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="audio_magnet")
    launcher.bind_({"datasource.train": "egs/sound/train",
                    "datasource.valid": "egs/sound/valid"})
    launcher.bind_({"fsdp.use": True,
                    "transformer_lm.causal": False,
                    "codebooks_pattern.modeling": "parallel"})
    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"), {"dataset.segment_duration": 10})
        sub(scale("medium"), {"dataset.segment_duration": 10},
            {"optim.optimizer": "adamw", "optim.lr": 1.0e-4})
