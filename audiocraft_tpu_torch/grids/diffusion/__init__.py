"""Multi-band diffusion grids (`audiocraft/grids/diffusion`)."""
