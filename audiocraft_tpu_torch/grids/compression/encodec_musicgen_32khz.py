"""The 32 kHz music EnCodec used by MusicGen
(`grids/compression/encodec_musicgen_32khz.py`): 50 Hz frame rate, 4
codebooks of 2048."""
from ._explorers import CompressionExplorer


@CompressionExplorer
def explorer(launcher):
    launcher.bind_(solver="compression")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid",
                    "sample_rate": 32000, "channels": 1,
                    "encodec.seanet.ratios": [8, 5, 4, 4],
                    "encodec.rvq.n_q": 4, "encodec.rvq.bins": 2048})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        sub()
        # exponent sweep on the commitment loss weight
        sub({"losses.commitment": 0.5})
