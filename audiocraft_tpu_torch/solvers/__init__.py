"""Training solvers: MusicGen and AudioGen LM training."""
from .audiogen import AudioGenSolver
from .builders import get_solver
from .musicgen import MusicGenSolver
