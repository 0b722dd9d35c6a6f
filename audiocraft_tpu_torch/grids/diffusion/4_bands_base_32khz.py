"""Multi-band diffusion decoders, one per EQ band
(`grids/diffusion/4_bands_base_32khz.py`): 4 jobs sharing the same EnCodec
tokens, each denoising its own frequency band."""
from ._explorers import DiffusionExplorer


@DiffusionExplorer
def explorer(launcher):
    launcher.bind_(solver="diffusion")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid",
                    "sample_rate": 32000})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        for band in range(4):
            sub({"filters.n_bands": 4, "filters.band_index": band})
