"""Decode attention: the port's plain version vs the JAX package's Pallas
kernel (interpret mode on the CPU), the plain version of the CUDA kernel's
split of the window (`decode_attention_split`) against both, the split's
shares and count, and the wrapper's routing and checks.
The CUDA kernel itself is tested on the card in `test_torch_gpu.py`.

Tolerances: f32 inputs agree to atol 1e-5 / rtol 1e-4 (same f32 algorithm,
sums in another order); the int8 cache is dequantized identically in f32 on
both sides, so the same tolerance holds."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.ops.flash_attention import \
    decode_attention as jax_decode_attention
from audiocraft_tpu_torch.ops.decode_attention import (
    BLOCKS_PER_SM, MAX_SPLIT, TILE, decode_attention, decode_attention_reference,
    decode_attention_split, length_tensor, split_count, tile_shares)

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


@pytest.mark.parametrize("sm_count", [8, 132])
@pytest.mark.parametrize("name", list(CASES))
def test_device_length_plain_versions_match_pallas_kernel(name, sm_count):
    """The length as the kernel reads it (one int32 tensor) through the
    reference and through the split of the window into the capacity-sized
    cluster the kernel launches (`split_count(B, H, S)`, shares past the
    window's end empty), against the TPU kernel's `length_ref`."""
    B, S, H, D, length, past_context, quant = CASES[name]
    q, k, v, ks, vs = _case(B, S, H, D, 13, quant)
    jax_scales = {} if ks is None else dict(
        k_scale=jnp.asarray(ks).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs).astype(jnp.bfloat16))
    expected = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(length, jnp.int32), past_context=past_context,
        **jax_scales))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            length_tensor(length, "cpu"))
    kwargs = dict(past_context=past_context)
    if ks is not None:
        kwargs.update(k_scale=torch.from_numpy(ks).to(torch.bfloat16),
                      v_scale=torch.from_numpy(vs).to(torch.bfloat16))
    n_split = split_count(B, H, S, sm_count)
    for got in (decode_attention_reference(*args, **kwargs),
                decode_attention_split(*args, n_split, **kwargs),
                decode_attention(*args, **kwargs)):
        np.testing.assert_allclose(got.numpy(), expected, atol=ATOL, rtol=RTOL)


def test_length_tensor_form_is_checked():
    q, k, v, _, _ = _case(1, 8, 2, 4, 5, False)
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    assert length_tensor(3, "cpu").dtype == torch.int32
    for bad in (torch.tensor([3]), torch.tensor([3, 4], dtype=torch.int32),
                torch.tensor([9], dtype=torch.int32)):
        with pytest.raises(ValueError):
            decode_attention(q, k, v, bad)


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


# The kernel's split-S: n shares of the window over 32-slot tiles, combined
# in rank order. B, S, H, D, length, past_context, int8; S = 100 spans four
# tiles, so 3 and 8 shares leave some shares empty.
SPLIT_CASES = {
    "length_1": (2, 100, 3, 16, 1, None, False),
    "length_37": (2, 100, 3, 16, 37, None, False),
    "length_s": (2, 100, 3, 16, 100, None, False),
    "window_0": (2, 100, 3, 16, 90, 0, False),
    "window_7": (2, 100, 3, 16, 70, 7, False),
    "int8_length_s": (2, 100, 3, 16, 100, None, True),
}


@functools.lru_cache(maxsize=None)
def _split_case(name):
    B, S, H, D, length, past_context, quant = SPLIT_CASES[name]
    q, k, v, ks, vs = _case(B, S, H, D, 11, quant)
    jax_scales = {} if ks is None else dict(
        k_scale=jnp.asarray(ks).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs).astype(jnp.bfloat16))
    expected = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(length, jnp.int32), past_context=past_context,
        **jax_scales))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            length)
    scales = {} if ks is None else dict(
        k_scale=torch.from_numpy(ks).to(torch.bfloat16),
        v_scale=torch.from_numpy(vs).to(torch.bfloat16))
    return expected, args, dict(past_context=past_context, **scales)


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_combine_matches_pallas_kernel_and_plain_version(name, n_split):
    expected, args, kwargs = _split_case(name)
    got = decode_attention_split(*args, n_split, **kwargs)
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, decode_attention_reference(*args, **kwargs),
                               atol=ATOL, rtol=RTOL)


def test_tile_shares_cover_the_window_once_in_order():
    for lo, hi in [(0, 1), (0, 37), (5, 100), (99, 100), (0, 1500), (40, 105)]:
        for n in range(1, MAX_SPLIT + 1):
            shares = tile_shares(lo, hi, n)
            assert len(shares) == n
            slots = [s for a, b in shares for s in range(a, b)]
            assert slots == list(range(lo, hi))
            for a, b in shares:  # shares start on a tile or at the window
                assert a == b or a == lo or a % TILE == 0


@pytest.mark.parametrize("B", [1, 2, 4, 32, 512, 4096])
@pytest.mark.parametrize("H", [5, 16, 24])
@pytest.mark.parametrize("window", [1, 31, 33, 64, 504, 1500, 40000])
def test_split_count_stays_in_range(B, H, window):
    n = split_count(B, H, window, sm_count=132)
    assert 1 <= n <= MAX_SPLIT and n <= window
    assert n == 1 or (n - 1) * B * H < BLOCKS_PER_SM * 132  # the fewest
    if B >= 512 or window < 2 * TILE:
        assert n == 1
