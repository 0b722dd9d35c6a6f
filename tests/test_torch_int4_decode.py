"""Int4-KV decode attention (K3): the port's packing and plain version vs
`scripts/pallas_int4_decode.py` (its Pallas kernel in interpret mode on the
CPU, as the script runs it off the TPU), the plain version of the CUDA
kernel's split of the window (`int4_decode_attention_split`) against both,
and the wrapper's routing and checks. The CUDA kernel itself is tested on the
card in `test_torch_gpu.py`.

Tolerances: the packed bytes and scales are bit-equal (the same bf16 steps);
the plain version is within 1e-2 * max(1, |jax|) of the kernel, whose running
max per 256-slot block can move a bf16-rounded weight by one ulp (it agrees
bit for bit when the window fits one block)."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu_torch.ops.int4_decode_attention import (
    int4_decode_attention, int4_decode_attention_reference,
    int4_decode_attention_split, quant_pack_kv)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "pallas_int4_decode.py"
TOL = 1e-2


@pytest.fixture(scope="module")
def script():
    """The script as a module; it sets a compilation cache directory when
    imported, which is restored right after."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("pallas_int4_decode", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return module


def _inputs(B, S, H, D, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(*shape).astype(np.float32)
               for shape in ((B, H, D), (B, S, H, D), (B, S, H, D)))
    return q, k, v


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_packing_is_bit_equal_to_the_script(script):
    _, k, v = _inputs(2, 40, 3, 128)
    k[0, 3] = 0.0  # an all-zero row takes the 1e-8 scale floor
    want = script.quant_pack_kv(jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16))
    got = quant_pack_kv(torch.from_numpy(k).bfloat16(),
                        torch.from_numpy(v).bfloat16())
    assert [tuple(t.shape) for t in got] == [(2, 40, 192), (2, 192, 40),
                                             (2, 40, 2, 3), (2, 40, 2, 3)]
    for name, a, b in zip(("k4", "v4t", "k_scale", "v_scale"), got, want):
        assert a.dtype == (torch.int8 if name[1] == "4" else torch.bfloat16)
        np.testing.assert_array_equal(_to_np(a), _to_np(b), err_msg=name)


CASES = {  # B, S, H, D, length, past_context, s_blk of the Pallas kernel
    "several_blocks": (2, 64, 4, 64, 64, None, 16),
    "ragged_length": (1, 48, 2, 64, 37, None, 256),
    "length_1": (2, 33, 2, 64, 1, None, 256),
    "window": (2, 48, 3, 64, 40, 7, 16),
    "d128": (1, 40, 2, 128, 29, None, 256),
    "window_d128_blocks": (1, 64, 2, 128, 64, 20, 16),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_the_pallas_kernel(script, name):
    B, S, H, D, length, past_context, s_blk = CASES[name]
    q, k, v = _inputs(B, S, H, D, seed=len(name))
    packed = script.quant_pack_kv(jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16))
    want = np.asarray(script.int4_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *packed, jnp.int32(length),
        past_context=past_context, s_blk=s_blk).astype(jnp.float32))
    tq = torch.from_numpy(q).bfloat16()
    tpacked = [torch.from_numpy(np.array(t)) if t.dtype == jnp.int8 else
               torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
               for t in packed]
    got = int4_decode_attention_reference(tq, *tpacked, length, past_context)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    err = np.abs(got.float().numpy() - want)
    assert (err <= TOL * np.maximum(1.0, np.abs(want))).all(), err.max()


def test_plain_version_tracks_full_precision_attention():
    """Quality of the int4 cache: against f32 attention over the bf16 K/V,
    the error relative to the output's max stays near the script's reported
    0.175 at B=4, S=64, length 48."""
    q, k, v = _inputs(4, 64, 16, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    out = int4_decode_attention(tq, *quant_pack_kv(tk, tv), 48).float()
    scores = torch.einsum("bhd,bshd->bhs", tq.float(), tk[:, :48].float()) / 8
    ref = torch.einsum("bhs,bshd->bhd", scores.softmax(-1), tv[:, :48].float())
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert 0.02 < rel < 0.35, rel


def test_wrapper_routes_cpu_tensors_to_the_plain_version_without_counting():
    q, k, v = _inputs(2, 24, 2, 32, seed=3)
    args = (torch.from_numpy(q), *quant_pack_kv(torch.from_numpy(k),
                                                 torch.from_numpy(v)), 17)
    before = int4_decode_attention.launches
    out = int4_decode_attention(*args, past_context=5)
    assert int4_decode_attention.launches == before
    assert out.dtype == torch.float32 and out.shape == (2, 2, 32)
    torch.testing.assert_close(out, int4_decode_attention_reference(
        *args, past_context=5), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["length_0", "length_past_s", "scale_shape",
                                 "odd_d", "k4_dtype", "window", "meta_device"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = _inputs(1, 8, 2, 8, seed=4)
    q = torch.from_numpy(q)
    k4, v4t, ks, vs = quant_pack_kv(torch.from_numpy(k), torch.from_numpy(v))
    length, window = 4, None
    if bad == "length_0":
        length = 0
    elif bad == "length_past_s":
        length = 9
    elif bad == "scale_shape":
        ks = ks[:, :, :1]
    elif bad == "odd_d":
        q = q[..., :7]
    elif bad == "k4_dtype":
        k4 = k4.to(torch.int16)
    elif bad == "window":
        window = -1
    elif bad == "meta_device":
        q = q.to("meta")
    with pytest.raises(ValueError):
        int4_decode_attention(q, k4, v4t, ks, vs, length, window)


# The kernel's split-S (128-slot tiles, n shares combined in rank order), as
# `int4_decode_attention_split` computes it. B, S, H, D, length,
# past_context; S = 384 spans three tiles, so 3 and 8 shares leave some empty
# and 2 shares hold two tiles and one.
SPLIT_CASES = {
    "length_1": (2, 384, 2, 64, 1, None),
    "length_37": (2, 384, 2, 64, 37, None),
    "length_s": (2, 384, 2, 64, 384, None),
    "window_0": (1, 384, 2, 32, 300, 0),
    "window_7": (1, 384, 3, 128, 260, 7),
    "window_200": (1, 384, 2, 64, 380, 200),
}


@functools.lru_cache(maxsize=None)
def _split_case(name):
    B, S, H, D, length, past_context = SPLIT_CASES[name]
    spec = importlib.util.spec_from_file_location("pallas_int4_decode", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    before = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    q, k, v = _inputs(B, S, H, D, seed=len(name) + 20)
    packed = module.quant_pack_kv(jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16))
    want = np.asarray(module.int4_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *packed, jnp.int32(length),
        past_context=past_context, s_blk=32).astype(jnp.float32))
    tq = torch.from_numpy(q).bfloat16()
    tpacked = [torch.from_numpy(np.array(t)) if t.dtype == jnp.int8 else
               torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
               for t in packed]
    return want, (tq, *tpacked, length), past_context


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_combine_matches_pallas_kernel_and_plain_version(name, n_split):
    want, args, past_context = _split_case(name)
    got = int4_decode_attention_split(*args, n_split, past_context)
    assert got.dtype == torch.bfloat16
    for ref in (want, int4_decode_attention_reference(
            *args, past_context).float().numpy()):
        err = np.abs(got.float().numpy() - ref)
        assert (err <= TOL * np.maximum(1.0, np.abs(ref))).all(), err.max()


def test_wrapper_takes_windows_past_the_old_cap():
    """No window cap: 30,000 valid slots (above the 28,672 that the kernel
    once held in shared memory) go through the wrapper's checks."""
    B, S, H, D = 1, 30_000, 1, 32
    rs = np.random.RandomState(9)
    k, v = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rs.randn(B, H, D).astype(np.float32))
    packed = quant_pack_kv(k, v)
    out = int4_decode_attention(q, *packed, S)
    assert out.shape == (B, H, D) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(
        out, int4_decode_attention_split(q, *packed, S, 8), atol=1e-2,
        rtol=1e-2)
