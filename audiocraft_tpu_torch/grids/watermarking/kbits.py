"""Message-capacity sweep (`grids/watermarking/kbits.py`): vary the number
of hidden message bits."""
from ._explorers import WatermarkingExplorer


@WatermarkingExplorer
def explorer(launcher):
    launcher.bind_(solver="watermarking")
    launcher.bind_({"datasource.train": "egs/audio/train",
                    "datasource.valid": "egs/audio/valid",
                    "sample_rate": 16000})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        for nbits in (0, 8, 16, 32):
            sub({"audioseal.nbits": nbits})
