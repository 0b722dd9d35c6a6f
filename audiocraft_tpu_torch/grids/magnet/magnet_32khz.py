"""MAGNeT 32 kHz music sweep (`grids/magnet/magnet_32khz.py`): non-AR
masked-token modeling, 10 s and 30 s variants."""
from ..musicgen.musicgen_base_32khz import scale
from ..musicgen._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="magnet")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})
    launcher.bind_({"fsdp.use": True,
                    "transformer_lm.causal": False,
                    "codebooks_pattern.modeling": "parallel"})
    seq10 = {"dataset.segment_duration": 10}
    seq30 = {"dataset.segment_duration": 30,
             "transformer_lm.subcodes_context": 5}

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"), seq10)
        sub(scale("small"), seq30)
        sub(scale("medium"), seq10,
            {"optim.optimizer": "adamw", "optim.lr": 1.0e-4})
