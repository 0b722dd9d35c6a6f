"""AudioSeal watermarking grids (`audiocraft/grids/watermarking`)."""
