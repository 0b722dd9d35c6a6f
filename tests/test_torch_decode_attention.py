"""Decode attention: the port's plain version vs the JAX package's Pallas
kernel (interpret mode on the CPU), and the wrapper's routing and checks.
The CUDA kernel itself is tested on the card in `test_torch_gpu.py`.

Tolerances: f32 inputs agree to atol 1e-5 / rtol 1e-4 (same f32 algorithm,
sums in another order); the int8 cache is dequantized identically in f32 on
both sides, so the same tolerance holds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.ops.flash_attention import \
    decode_attention as jax_decode_attention
from audiocraft_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)

ATOL, RTOL = 1e-5, 1e-4


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _quantize(x):
    scale = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    q = np.round(x / np.maximum(scale, 1e-8)).astype(np.int8)
    return q, scale


def _case(B, S, H, D, seed, quant):
    q = _rand(seed, B, H, D)
    k, v = _rand(seed + 1, B, S, H, D), _rand(seed + 2, B, S, H, D)
    if not quant:
        return q, k, v, None, None
    (k, ks), (v, vs) = _quantize(k), _quantize(v)
    return q, k, v, ks, vs


CASES = {  # B, S, H, D, length, past_context, int8
    "f32": (2, 64, 4, 16, 23, None, False),
    "window": (1, 48, 2, 8, 40, 10, False),
    "multiblock": (1, 1024, 2, 8, 700, None, False),
    "int8": (2, 64, 4, 16, 37, None, True),
    "int8_window": (2, 64, 4, 16, 64, 5, True),
    "first_step": (2, 32, 4, 16, 1, None, False),
    "full": (2, 32, 4, 16, 32, None, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_pallas_kernel(name):
    B, S, H, D, length, past_context, quant = CASES[name]
    q, k, v, ks, vs = _case(B, S, H, D, 7, quant)
    jax_scales = {} if ks is None else dict(
        k_scale=jnp.asarray(ks).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs).astype(jnp.bfloat16))
    expected = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    jnp.asarray(length, jnp.int32),
                                    past_context=past_context, **jax_scales)
    torch_scales = {} if ks is None else dict(
        k_scale=torch.from_numpy(ks[..., 0]).to(torch.bfloat16),
        v_scale=torch.from_numpy(vs).to(torch.bfloat16))  # [B,S,H] and [B,S,H,1]
    got = decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), length,
                                     past_context=past_context, **torch_scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               atol=ATOL, rtol=RTOL)


def test_wrapper_routes_cpu_tensors_to_reference_without_counting():
    q, k, v, ks, vs = _case(2, 40, 4, 16, 3, True)
    args = (torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k),
            torch.from_numpy(v), 17)
    scales = dict(k_scale=torch.from_numpy(ks).to(torch.bfloat16),
                  v_scale=torch.from_numpy(vs).to(torch.bfloat16))
    before = decode_attention.launches
    out = decode_attention(*args, **scales)
    assert decode_attention.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 16)
    torch.testing.assert_close(out, decode_attention_reference(*args, **scales),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["lone_scale", "int8_no_scale", "length",
                                 "shape", "meta_device"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v, ks, vs = _case(1, 8, 2, 4, 5, True)
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    ks = torch.from_numpy(ks).to(torch.bfloat16)
    kwargs = dict(k_scale=ks, v_scale=ks)
    length = 4
    if bad == "lone_scale":
        kwargs = dict(k_scale=ks)
    elif bad == "int8_no_scale":
        kwargs = {}
    elif bad == "length":
        length = 9
    elif bad == "shape":
        q = q[:, :1]
    elif bad == "meta_device":
        q = q.to("meta")
    with pytest.raises(ValueError):
        decode_attention(q, k, v, length, **kwargs)
