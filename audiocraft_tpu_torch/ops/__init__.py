"""Attention ops and the hand-written CUDA kernels behind them."""
from .attention import dot_product_attention, make_causal_bias, repeat_kv
from .decode_attention import decode_attention, decode_attention_reference
