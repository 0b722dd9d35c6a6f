"""Models: the LM, EnCodec and the MusicGen, AudioGen and MAGNeT
wrappers."""
from .audiogen import AudioGen
from .encodec import CompressionModel, EncodecModel
from .lm import GenParams, LMModel
from .lm_magnet import MagnetLMModel
from .magnet import MAGNeT
from .musicgen import MusicGen
