"""MusicGen training/eval grids (`audiocraft/grids/musicgen`)."""
