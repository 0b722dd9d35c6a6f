"""Tiny single-chip EnCodec debug run (`grids/compression/debug.py`):
sanity-check the GAN training loop end to end."""
from ._explorers import CompressionExplorer


@CompressionExplorer
def explorer(launcher):
    launcher.bind_(solver="compression")
    launcher.tpu_(chips=1, label="debug")
    with launcher.job_array():
        launcher.bind()({"dataset.batch_size": 8,
                         "dataset.segment_duration": 1.0,
                         "optim.epochs": 2})
