"""Models: the LM, EnCodec, the MusicGen, AudioGen and MAGNeT wrappers,
Multi-Band Diffusion, AudioSeal and JASCO."""
from .audiogen import AudioGen
from .encodec import CompressionModel, EncodecModel
from .flow_matching import FlowMatchingModel
from .jasco import JASCO
from .lm import GenParams, LMModel
from .lm_magnet import MagnetLMModel
from .magnet import MAGNeT
from .multibanddiffusion import MultiBandDiffusion
from .musicgen import MusicGen
from .unet import DiffusionUnet
from .watermark import AudioSeal, AudioSealDetector, AudioSealWM, WMModel
