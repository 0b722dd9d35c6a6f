"""PyTorch/CUDA port of `audiocraft_tpu` (MusicGen text-to-music).

The port imports torch and numpy only. Its entry points run on the CUDA
device unless the caller passes `device="cpu"`; the decode-attention step
runs a hand-written Hopper kernel (`csrc/decode_attention.cu`) on CUDA
tensors and its plain PyTorch version on CPU tensors.
"""
