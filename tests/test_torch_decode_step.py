"""The decode step at a device offset against the JAX package, in f32 on the
CPU: `KVCache.write` at the cache's device index (f32, bf16 and int8
buffers) against a write by slicing and against the JAX cache's
`dynamic_update_slice`, and greedy generation of the debug LM through the
port's one step function (batched CFG, two-step CFG, continuation of a code
prompt) against the JAX package's prefill + `lax.scan`.

Tolerance: cache buffers, scales and indices equal bit for bit (the same
f32 or bf16 values; int8 values and bf16 scales from the same rounding);
greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import transformer as jtr
from audiocraft_tpu.modules.conditioners import \
    ConditioningAttributes as JaxAttrs
from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.models.lm import GenParams
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.modules.transformer import KVCache
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["happy rock with loud drums", "jazz"]
CHUNKS = [3, 1, 1, 2, 1]  # steps written per call: a prefill, then decode
B, S, H, D = 2, 10, 3, 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_cache_write_at_device_offset_equals_slicing_write(dtype):
    rng = np.random.RandomState(0)
    chunks = [(rng.randn(B, t, H, D).astype(np.float32),
               rng.randn(B, t, H, D).astype(np.float32)) for t in CHUNKS]
    cache = KVCache.create(B, S, H, D, getattr(torch, dtype), "cpu")
    # the slicing write: the buffers at host offsets
    want = {name: torch.zeros_like(getattr(cache, name))
            for name in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, name) is not None}
    jcache = jtr.KVCache.create(B, S, H, D, dtype=getattr(jnp, dtype))
    offset = 0
    for k, v in chunks:
        end = offset + k.shape[1]
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        if dtype == "int8":
            (kq, ks), (vq, vs) = KVCache._quantize(kt), KVCache._quantize(vt)
            for name, value in (("k", kq), ("v", vq), ("k_scale", ks),
                                ("v_scale", vs)):
                want[name][:, offset:end] = value
        else:
            want["k"][:, offset:end] = kt.to(want["k"].dtype)
            want["v"][:, offset:end] = vt.to(want["v"].dtype)
        cache.write(kt, vt)
        jcache = jcache.write(jnp.asarray(k), jnp.asarray(v), offset)
        offset = end
    assert cache.index.dtype == torch.int32 and int(cache.index) == offset
    assert int(jcache.index) == offset
    for name, value in want.items():
        got = getattr(cache, name)
        assert torch.equal(got, value), name
        jvalue = np.asarray(getattr(jcache, name).astype(jnp.float32))
        np.testing.assert_array_equal(
            got.float().numpy(), jvalue.reshape(got.shape), err_msg=name)


@pytest.fixture(scope="module")
def debug_lm():
    jmodel, params = jbuilders.get_debug_lm_model()
    port = builders.get_debug_lm_model(device="cpu")
    jax_weights.load_lm(port, jax.tree.map(np.asarray, params))
    return jmodel, params, port


@pytest.mark.parametrize("mode", ["batched_cfg", "two_step_cfg",
                                  "continuation"])
def test_step_function_greedy_tokens_match_jax(debug_lm, mode):
    jmodel, params, port = debug_lm
    prompt = None
    if mode == "continuation":
        prompt = np.random.RandomState(5).randint(0, 400, (2, 4, 5))
    two_step = mode == "two_step_cfg"
    expected = jlm.generate(
        jmodel, params, jax.random.PRNGKey(0),
        prompt=None if prompt is None else jnp.asarray(prompt),
        conditions=[JaxAttrs(text={"description": t}) for t in TEXTS],
        max_gen_len=14, gen=jlm.GenParams(use_sampling=False, cfg_coef=3.0,
                                          two_step_cfg=two_step))
    got = port.generate(
        prompt=None if prompt is None else torch.from_numpy(prompt),
        conditions=[ConditioningAttributes(text={"description": t})
                    for t in TEXTS],
        max_gen_len=14, gen=GenParams(use_sampling=False, cfg_coef=3.0,
                                      two_step_cfg=two_step),
        device="cpu")
    assert got.shape == (2, 4, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    if prompt is not None:
        np.testing.assert_array_equal(got[..., :5].numpy(), prompt)


def test_progress_callback_is_stored():
    mg = MusicGen.get_pretrained("debug", device="cpu")
    seen = []
    mg.set_custom_progress_callback(lambda done, total: seen.append(done))
    assert mg._progress_callback is not None
    mg.set_custom_progress_callback(None)
    assert mg._progress_callback is None
