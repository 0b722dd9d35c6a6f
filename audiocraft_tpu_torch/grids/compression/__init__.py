"""EnCodec training grids (`audiocraft/grids/compression`)."""
