"""Device selection, sampling and the carry-over of JAX parameters."""
