"""CLAP-embedding conditioned sweep (`grids/musicgen/musicgen_clapemb_32khz.py`).

Note: the CLAP conditioner requires a local CLAP checkpoint (zero-egress
environment); the grid declares the sweep regardless."""
from .musicgen_base_32khz import scale
from ._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})
    clap = {
        "conditioners.description.model": "clap",
        "conditioners.description.clap.checkpoint": "//reference/clap/music_audioset_epoch_15_esc_90.14.pt",
        "conditioners.description.clap.audio_stride": 1,
        "conditioners.description.clap.enable_fusion": False,
    }
    launcher.bind_(clap, {"fsdp.use": True})
    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"))
        sub(scale("small"), {"conditioners.description.clap.text_p": 0.5})
