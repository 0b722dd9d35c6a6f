"""Attention ops and the hand-written CUDA kernels behind them."""
from .attention import (dot_product_attention, dropout, flash_causal_eligible,
                        make_causal_bias, repeat_kv)
from .cross_attention_step import (cross_attention_step,
                                   cross_attention_step_reference)
from .decode_attention import decode_attention, decode_attention_reference
from .flash_causal_attention import (flash_causal_attention,
                                     flash_causal_attention_reference)
