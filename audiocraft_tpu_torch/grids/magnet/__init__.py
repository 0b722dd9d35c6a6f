"""MAGNeT training/eval grids (`audiocraft/grids/magnet`)."""
