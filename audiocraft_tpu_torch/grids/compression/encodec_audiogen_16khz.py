"""The 16 kHz sound EnCodec used by AudioGen
(`grids/compression/encodec_audiogen_16khz.py`)."""
from ._explorers import CompressionExplorer


@CompressionExplorer
def explorer(launcher):
    launcher.bind_(solver="compression")
    launcher.bind_({"datasource.train": "egs/sound/train",
                    "datasource.valid": "egs/sound/valid",
                    "sample_rate": 16000, "channels": 1,
                    "encodec.seanet.ratios": [8, 5, 4, 2],
                    "encodec.rvq.n_q": 4, "encodec.rvq.bins": 2048})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        launcher.bind()()
