"""Training solvers: MusicGen, AudioGen and MAGNeT LM training, EnCodec,
Multi-Band Diffusion and JASCO training, and the run loop they share."""
from .audiogen import AudioGenSolver
from .base import SolverRunMixin, StandardSolver
from .builders import get_solver
from .compression import CompressionSolver
from .diffusion import DiffusionSolver
from .jasco import JascoSolver
from .magnet import AudioMagnetSolver, MagnetSolver
from .musicgen import MusicGenSolver
