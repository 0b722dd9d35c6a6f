"""AudioGen training/eval grids (`audiocraft/grids/audiogen`)."""
