"""AudioGen solver: the MusicGen solver over sound (counterpart of
`audiocraft_tpu/solvers/audiogen.py`)."""
from .musicgen import MusicGenSolver


class AudioGenSolver(MusicGenSolver):
    DATASET_TYPE = "sound"
