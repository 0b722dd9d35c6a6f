"""Base sweep with precomputed condition caches
(`grids/musicgen/musicgen_base_cached_32khz.py`): identical model points,
with EnCodec tokens and T5 embeddings read from a cache to keep host-side
tokenization off the step critical path."""
from .musicgen_base_32khz import scale
from ._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})
    launcher.bind_({"cache.path": "cache/musicgen_32khz",
                    "cache.write": False,
                    "fsdp.use": True})

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        launcher.bind()(scale("small"))
    launcher.tpu_(chips=64, label="v5e-64")
    with launcher.job_array():
        launcher.bind()(scale("medium"),
                        {"optim.optimizer": "adamw", "optim.lr": 1.0e-4})
