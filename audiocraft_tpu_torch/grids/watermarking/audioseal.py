"""AudioSeal training (`grids/watermarking/audioseal.py`): joint
generator/detector with the full attack suite."""
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
        sub()
        sub({"losses.tf_loudnessratio": 5.0})
