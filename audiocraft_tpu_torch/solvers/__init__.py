"""Training solvers: MusicGen, AudioGen and MAGNeT LM training, and the run
loop they share."""
from .audiogen import AudioGenSolver
from .base import SolverRunMixin, StandardSolver
from .builders import get_solver
from .magnet import AudioMagnetSolver, MagnetSolver
from .musicgen import MusicGenSolver
