"""Transformer pieces of the port vs the JAX package, in f32 on the CPU:
attention ops, sinusoidal embedding, the MHA decode step over a static
(f32 or int8) cache under both JAX decode backends, and the streaming
transformer (full forward and step-by-step decode).

Tolerance: atol 1e-5 / rtol 1e-4 (f32 everywhere, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.modules import transformer as jtr
from audiocraft_tpu.ops import attention as jattn
from audiocraft_tpu_torch.modules import transformer as ttr
from audiocraft_tpu_torch.ops import attention as tattn
from audiocraft_tpu_torch.utils import jax_weights

ATOL, RTOL = 1e-5, 1e-4


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, expected, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("past_context", [None, 3])
def test_make_causal_bias(past_context):
    q_pos, k_pos = np.arange(4) + 5, np.arange(12)
    k_valid = np.arange(12) < 9
    expected = jattn.make_causal_bias(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                      past_context, jnp.asarray(k_valid))
    got = tattn.make_causal_bias(torch.from_numpy(q_pos),
                                 torch.from_numpy(k_pos), past_context,
                                 torch.from_numpy(k_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("as_float32", [True, False])
def test_dot_product_attention_with_bias(as_float32):
    q, k, v = _rand(0, 2, 3, 4, 8), _rand(1, 2, 6, 4, 8), _rand(2, 2, 6, 4, 8)
    bias = np.where(np.arange(6)[None] < np.arange(3)[:, None] + 3, 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    expected = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(bias),
                                           as_float32=as_float32)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v),
                                      torch.from_numpy(bias),
                                      as_float32=as_float32)
    _close(got, expected)


def test_repeat_kv_and_sin_embedding():
    x = _rand(3, 2, 5, 3, 4)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(x), 2).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(x), 2)))
    pos = np.arange(7).reshape(1, -1, 1) + 11
    _close(ttr.create_sin_embedding(torch.from_numpy(pos), 32),
           jtr.create_sin_embedding(jnp.asarray(pos), 32))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_mha_decode_step_matches_jax(backend, cache_dtype):
    """Prefill 5 steps, then one decode step: the port's step goes through
    the decode-attention wrapper (plain version on the CPU)."""
    B, E, H, S = 2, 32, 4, 16
    mha = jtr.StreamingMultiheadAttention(embed_dim=E, num_heads=H, causal=True)
    x0, x1 = _rand(9, B, 5, E), _rand(10, B, 1, E)
    params = mha.init(jax.random.PRNGKey(0), x0, x0, x0)
    jcache = jtr.KVCache.create(B, S, H, E // H, dtype=getattr(jnp, cache_dtype))
    y0, jcache = mha.apply(params, x0, x0, x0, cache=jcache)
    try:
        jtr.set_efficient_attention_backend(backend)
        y1, _ = mha.apply(params, x1, x1, x1, cache=jcache)
    finally:
        jtr.set_efficient_attention_backend("xla")

    port = ttr.StreamingMultiheadAttention(E, H, causal=True)
    jax_weights.load_mha(port, _np(params))
    cache = ttr.KVCache.create(B, S, H, E // H, getattr(torch, cache_dtype))
    _close(port(torch.from_numpy(x0), cache=cache), y0)
    _close(port(torch.from_numpy(x1), cache=cache), y1)
    assert cache.index == 6


def _jax_transformer(norm_first):
    return jtr.StreamingTransformer(d_model=32, num_heads=4, num_layers=2,
                                    dim_feedforward=64, causal=True,
                                    cross_attention=True, norm_first=norm_first,
                                    use_bias_ff=False, use_bias_attn=True)


def _port_transformer(norm_first, params):
    port = ttr.StreamingTransformer(32, 4, 2, dim_feedforward=64, causal=True,
                                    cross_attention=True, norm_first=norm_first,
                                    bias_ff=False, bias_attn=True)
    jax_weights.load_transformer(port, _np(params)["params"])
    return port


@pytest.mark.parametrize("norm_first", [True, False])
def test_streaming_transformer_forward_matches_jax(norm_first):
    x, src = _rand(20, 2, 7, 32), _rand(21, 2, 3, 32)
    model = _jax_transformer(norm_first)
    params = model.init(jax.random.PRNGKey(1), x, cross_attention_src=src)
    expected, _ = model.apply(params, x, cross_attention_src=src)
    port = _port_transformer(norm_first, params)
    _close(port(torch.from_numpy(x), cross_attention_src=torch.from_numpy(src)),
           expected)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_streaming_transformer_step_decode_matches_jax(cache_dtype):
    """Prefill 3 steps then decode 4 single steps through the caches, the
    cross K/V precomputed once; every step equals JAX's."""
    x, src = _rand(22, 2, 7, 32), _rand(23, 2, 3, 32)
    model = _jax_transformer(True)
    params = model.init(jax.random.PRNGKey(2), x, cross_attention_src=src)
    jcaches = model.apply(params, 2, 8, getattr(jnp, cache_dtype),
                          method=jtr.StreamingTransformer.init_cache)
    jcaches = model.apply(params, jnp.asarray(src), jcaches,
                          method=jtr.StreamingTransformer.precompute_cross_kv)
    port = _port_transformer(True, params)
    caches = port.init_cache(2, 8, getattr(torch, cache_dtype))
    port.precompute_cross_kv(torch.from_numpy(src), caches)
    for lo, hi in [(0, 3), (3, 4), (4, 5), (5, 6), (6, 7)]:
        expected, jcaches = model.apply(params, x[:, lo:hi],
                                        cross_attention_src=src,
                                        caches=jcaches)
        got = port(torch.from_numpy(x[:, lo:hi]),
                   cross_attention_src=torch.from_numpy(src), caches=caches)
        _close(got, expected)
