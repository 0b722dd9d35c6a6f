"""EnCodec 24 kHz base training (`grids/compression/encodec_base_24khz.py`)."""
from ._explorers import CompressionExplorer


@CompressionExplorer
def explorer(launcher):
    launcher.bind_(solver="compression")
    launcher.bind_({"datasource.train": "egs/audio/train",
                    "datasource.valid": "egs/audio/valid",
                    "sample_rate": 24000, "channels": 1})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        launcher.bind()()
