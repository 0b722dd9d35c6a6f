"""Training solvers: MusicGen LM training."""
from .builders import get_solver
from .musicgen import MusicGenSolver
