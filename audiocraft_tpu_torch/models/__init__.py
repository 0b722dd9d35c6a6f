"""Models: the LM, EnCodec and the MusicGen and AudioGen wrappers."""
from .audiogen import AudioGen
from .encodec import CompressionModel, EncodecModel
from .lm import GenParams, LMModel
from .musicgen import MusicGen
