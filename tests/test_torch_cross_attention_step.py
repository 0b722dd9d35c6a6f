"""The cross-attention step (K4, `ops/cross_attention_step.py`): its plain
version against the plain attention, the wrapper's checks, the layout that
`precompute_cross_kv` stores, and the routing of
`StreamingMultiheadAttention`; then, on a card (marker `gpu`), the kernel
against its plain version.

This file imports torch and the port only, so its card tests also run
where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cross_attention_step.py

Tolerances: on the CPU, f32 against the plain attention 1e-6 (the same
f32 math in another product order). On the card, against the plain
version on the same inputs: f32 outputs 1e-5; bf16 outputs 4e-3 absolute
plus 8e-3 relative (one bf16 ulp, 2^-7 of the value at most, where the
kernel's f32 result and the plain version's round apart), and for every
dtype a relative L2 distance from the f32 plain version under 4e-3 (bf16
rounding alone reads about 1e-3; a key left out at Tc 512 reads several
per cent).
"""
import pytest
import torch

from audiocraft_tpu_torch.models import lm as lm_module
from audiocraft_tpu_torch.modules import transformer as ttr
from audiocraft_tpu_torch.ops.attention import dot_product_attention
from audiocraft_tpu_torch.ops.cross_attention_step import (
    _DTYPE_CODES as K4_DTYPE_CODES, _launcher as k4_launcher,
    cross_attention_step, cross_attention_step_reference, warps_per_head)


def _qkv(B, H, Tc, D, q_dtype=torch.float32, kv_dtype=torch.float32,
         device="cpu", seed=0):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device=device).to(q_dtype)
    k, v = (torch.randn(B, H, Tc, D, generator=g, device=device).to(kv_dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("B", [1, 6])
@pytest.mark.parametrize("Tc", [1, 7, 40, 129])
def test_reference_matches_plain_attention(Tc, B):
    q, k, v = _qkv(B, 4, Tc, 64, seed=Tc + B)
    want = dot_product_attention(q[:, None], k.transpose(1, 2),
                                 v.transpose(1, 2), as_float32=True)[:, 0]
    got = cross_attention_step_reference(q, k, v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    before = cross_attention_step.launches
    routed = cross_attention_step(q, k, v)
    assert cross_attention_step.launches == before  # nothing launched
    torch.testing.assert_close(routed, got, atol=0, rtol=0)


def test_reference_keeps_q_dtype_and_computes_in_f32():
    q, k, v = _qkv(3, 2, 9, 16, torch.bfloat16, torch.bfloat16)
    out = cross_attention_step(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 2, 16)
    want = cross_attention_step_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(out, want.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("bad", [
    "q_rank", "kv_shapes_differ", "q_mismatch", "no_key", "odd_head_dim",
    "head_dim_not_multiple_of_8", "wide_head_dim", "half_q", "int8_kv",
    "mixed_kv", "q_dtype_differs", "strided_k", "strided_q", "misaligned_v",
    "meta_device"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = _qkv(2, 3, 5, 8)
    if bad == "q_rank":
        q = q[:, None]
    elif bad == "kv_shapes_differ":
        v = v[:, :, :4]
    elif bad == "q_mismatch":
        q = q[:, :2]
    elif bad == "no_key":
        k, v = k[:, :, :0], v[:, :, :0]
    elif bad == "odd_head_dim":
        q, k, v = q[..., :7], k[..., :7].contiguous(), v[..., :7].contiguous()
        q = q.contiguous()
    elif bad == "head_dim_not_multiple_of_8":
        q, k, v = _qkv(2, 3, 5, 12)
    elif bad == "wide_head_dim":
        q, k, v = _qkv(2, 3, 5, 136)
    elif bad == "half_q":
        q = q.half()
    elif bad == "int8_kv":
        k, v = k.to(torch.int8), v.to(torch.int8)
    elif bad == "mixed_kv":
        v = v.to(torch.bfloat16)
    elif bad == "q_dtype_differs":
        q = q.to(torch.bfloat16)
    elif bad == "strided_k":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "strided_q":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned_v":  # contiguous, 4 bytes past a 16-byte line
        v = torch.empty(v.numel() + 4)[1:1 + v.numel()].view(v.shape).copy_(v)
    elif bad == "meta_device":
        q = q.to("meta")
    before = cross_attention_step.launches
    with pytest.raises(ValueError):
        cross_attention_step(q, k, v)
    assert cross_attention_step.launches == before


@pytest.mark.parametrize("B, H, sms, want", [
    (192, 16, 132, 1), (4, 24, 132, 4), (1, 16, 132, 4), (30, 16, 132, 2),
    (66, 16, 132, 1)])
def test_warps_per_head_fill_the_card(B, H, sms, want):
    assert warps_per_head(B, H, sms) == want


@pytest.fixture
def routed(monkeypatch):
    """The calls that the attention layer routes to the kernel's wrapper.
    On the CPU the wrapper computes the plain version and launches
    nothing, so the route is read from this spy, not from the launch
    counter."""
    calls = []

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return cross_attention_step(q, k, v)

    monkeypatch.setattr(ttr, "cross_attention_step", spy)
    return calls


def _cross_transformer(seed=0, D=16, layers=2):
    torch.manual_seed(seed)
    return ttr.StreamingTransformer(4 * D, 4, layers, dim_feedforward=32,
                                    causal=True, cross_attention=True).eval()


def test_precompute_cross_kv_stores_contiguous_kernel_layout():
    model = _cross_transformer()
    src = torch.randn(3, 5, 64)
    caches = model.init_cache(3, 8)
    model.precompute_cross_kv(src, caches)
    for layer, cache in zip(model.layers, caches):
        k, v = layer.cross_attention.project_kv(src)  # [B, Tc, H, D]
        for stored, want in ((cache.cross_k, k), (cache.cross_v, v)):
            assert stored.shape == (3, 4, 5, 16) and stored.is_contiguous()
            torch.testing.assert_close(stored, want.transpose(1, 2),
                                       atol=0, rtol=0)


def test_training_forward_is_the_plain_attention(routed):
    """In training mode a cached single-step cross call keeps the plain
    attention (with its dropout), over the stored keys and values read back
    in the projection's layout; nothing goes through the kernel."""
    model = _cross_transformer()
    attn = model.layers[0].cross_attention.train()
    query, src = torch.randn(2, 1, 64), torch.randn(2, 6, 64)
    caches = model.init_cache(2, 4)
    model.precompute_cross_kv(src, caches)
    got = attn(query, cross_kv=(caches[0].cross_k, caches[0].cross_v))
    assert routed == []
    q = torch.nn.functional.linear(query, attn.in_proj_weight[:64],
                                   attn.in_proj_bias[:64]).reshape(2, 1, 4, 16)
    k, v = attn.project_kv(src)
    want = attn.out_proj(dot_product_attention(q, k, v).reshape(2, 1, 64))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(attn(query, src), want, atol=1e-6, rtol=1e-6)


def test_routing_takes_only_cached_single_steps_outside_training(routed):
    model = _cross_transformer()
    attn = model.layers[0].cross_attention
    src = torch.randn(2, 6, 64)
    caches = model.init_cache(2, 4)
    model.precompute_cross_kv(src, caches)
    cross_kv = (caches[0].cross_k, caches[0].cross_v)
    step, steps = torch.randn(2, 1, 64), torch.randn(2, 3, 64)

    def launches(fn):
        before = len(routed)
        out = fn()
        return len(routed) - before, out

    n, routed = launches(lambda: attn(step, cross_kv=cross_kv))
    assert n == 1
    n, plain = launches(lambda: attn(step, src))  # not precomputed
    assert n == 0
    torch.testing.assert_close(routed, plain, atol=1e-6, rtol=1e-6)
    n, many = launches(lambda: attn(steps, cross_kv=cross_kv))  # T > 1
    assert n == 0
    torch.testing.assert_close(many, attn(steps, src), atol=1e-6, rtol=1e-6)
    attn.train()
    n, _ = launches(lambda: attn(step, cross_kv=cross_kv))
    attn.eval()
    assert n == 0
    # K/V of another dtype than the query: the plain attention takes them
    half_kv = tuple(t.to(torch.bfloat16) for t in cross_kv)
    n, mixed = launches(lambda: attn(step, cross_kv=half_kv))
    assert n == 0
    q = torch.nn.functional.linear(step, attn.in_proj_weight[:64],
                                   attn.in_proj_bias[:64]).reshape(2, 1, 4, 16)
    want = attn.out_proj(dot_product_attention(
        q, *(t.transpose(1, 2) for t in half_kv)).reshape(2, 1, 64))
    torch.testing.assert_close(mixed, want, atol=1e-6, rtol=1e-6)


def test_cached_decode_routes_every_layer_step_and_matches_the_full_pass(
        routed):
    """A prefill of 3 steps, then 4 single steps through the caches: each
    single step takes the kernel's route once per layer, and the steps'
    outputs equal the uncached forward over the whole sequence."""
    model = _cross_transformer(seed=3, layers=3)
    x, src = torch.randn(2, 7, 64), torch.randn(2, 5, 64)
    with torch.no_grad():
        want = model(x, cross_attention_src=src)
        caches = model.init_cache(2, 7)
        model.precompute_cross_kv(src, caches)
        got = [model(x[:, :3], cross_attention_src=src, caches=caches)]
        assert routed == []
        got += [model(x[:, t:t + 1], cross_attention_src=src, caches=caches)
                for t in range(3, 7)]
    assert routed == [(2, 4, 16)] * (3 * 4)
    torch.testing.assert_close(torch.cat(got, dim=1), want, atol=1e-5,
                               rtol=1e-5)


# -- on a card ---------------------------------------------------------------

CARD_CASES = {
    # name: B, H, Tc, D, dtype of q, k and v
    "gen96": (192, 16, 40, 64, torch.bfloat16),
    "req2": (4, 24, 40, 64, torch.bfloat16),
    "tc_1": (8, 16, 1, 64, torch.bfloat16),
    "tc_512": (4, 16, 512, 64, torch.bfloat16),
    "f32_kv": (6, 16, 77, 64, torch.float32),
    "d128": (6, 32, 129, 128, torch.bfloat16),
    "d128_f32": (3, 8, 65, 128, torch.float32),  # a row over all 32 lanes
    "d8_one_lane_a_key": (5, 5, 300, 8, torch.bfloat16),
    "d24_idle_lanes_f32": (3, 5, 17, 24, torch.float32),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _assert_kernel_close(out, q, k, v):
    """out against the plain version on the same inputs (the module
    docstring's tolerances)."""
    want = cross_attention_step_reference(q, k, v).float()
    exact = cross_attention_step_reference(q.float(), k.float(), v.float())
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(out.float(), want, atol=4e-3, rtol=8e-3)
    rel = (torch.linalg.vector_norm(out.float() - exact)
           / torch.linalg.vector_norm(exact))
    assert rel < 4e-3, f"relative L2 distance {float(rel)}"


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_kernel_matches_reference(name):
    _card()
    B, H, Tc, D, dtype = CARD_CASES[name]
    q, k, v = _qkv(B, H, Tc, D, dtype, dtype, "cuda", seed=Tc)
    before = cross_attention_step.launches
    out = cross_attention_step(q, k, v)
    torch.cuda.synchronize()
    assert cross_attention_step.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, H, D)
    _assert_kernel_close(out, q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("wph", [1, 2, 4])
@pytest.mark.parametrize("name", ["req2", "tc_1", "tc_512", "d128_f32",
                                  "d8_one_lane_a_key", "d24_idle_lanes_f32"])
def test_cuda_kernel_every_warps_per_head(name, wph):
    """The C launcher at 1, 2 and 4 warps to a (row, head) (the wrapper's
    choice aside), against the plain version."""
    _card()
    B, H, Tc, D, dtype = CARD_CASES[name]
    q, k, v = _qkv(B, H, Tc, D, dtype, dtype, "cuda", seed=wph)
    out = torch.empty_like(q)
    err = k4_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Tc, D,
        K4_DTYPE_CODES[dtype], wph, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    _assert_kernel_close(out, q, k, v)


@pytest.mark.gpu
def test_cuda_kernel_in_a_graph_counted_per_replay():
    """K4 captured once into a CUDA graph and replayed over new queries,
    each output held against the plain version; then through
    `_replay_decode_steps`, which counts the captured launch once per
    replay and none at capture."""
    _card()
    B, H, Tc, D = 192, 16, 40, 64
    q, k, v = _qkv(B, H, Tc, D, torch.bfloat16, torch.bfloat16, "cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the build, outside the capture
        cross_attention_step(q, k, v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        out = cross_attention_step(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.Generator("cuda").manual_seed(9)
    for _ in range(4):
        q.copy_(torch.randn(B, H, D, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        _assert_kernel_close(out, q, k, v)

    state = {"out": None}

    def step():
        q.mul_(-1.0)
        state["out"] = cross_attention_step(q, k, v)

    steps = 6
    before = cross_attention_step.launches
    lm_module._replay_decode_steps(step, steps, q.device, None)
    torch.cuda.synchronize()
    assert cross_attention_step.launches == before + steps
    _assert_kernel_close(state["out"], q, k, v)
