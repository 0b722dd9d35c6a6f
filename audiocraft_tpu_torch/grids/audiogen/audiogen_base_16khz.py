"""AudioGen 16 kHz base sweep (`grids/audiogen/audiogen_base_16khz.py`):
text-to-sound over sound-effect datasets, medium model."""
from ..musicgen.musicgen_base_32khz import scale
from ..musicgen._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="audiogen")
    launcher.bind_({"datasource.train": "egs/sound/train",
                    "datasource.valid": "egs/sound/valid"})
    launcher.bind_({"fsdp.use": True,
                    "classifier_free_guidance.training_dropout": 0.1})
    adam = {"optim.optimizer": "adamw", "optim.lr": 5.0e-4}

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        launcher.bind()(scale("medium"), adam)
