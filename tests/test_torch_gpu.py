"""Tests that need an NVIDIA card (marker `gpu`); they skip without one.

This file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: decode attention, f32 caches 1e-4, bf16 and int8 caches 2e-2
(bf16 output rounding of values of order 1); causal flash attention against
its plain version in f32 on the same inputs, |err| <= tol * (1 + |plain|)
with tol 1e-5 (f32 output), 1e-4 (f32 gradients) and 2e-2 (bf16); int4
decode attention against its plain version, |err| <= 1e-2 * max(1, |plain|)
(sums in another order can move a bf16-rounded weight by one ulp); the int8
product's int32 sums exactly; HTDemucs on the card against the CPU, atol
1e-4 * max(1, max |CPU|) (f32 cuFFT and cuDNN against the CPU's FFT and
convolutions, TF32 off); greedy tokens equal; Multi-Band Diffusion,
AudioSeal and JASCO on the card against the CPU with the same weights and
noise, atol 1e-4 * max(1, max |CPU|) (f32, TF32 off), and the same number
of Dormand-Prince evaluations; K2's ops against their plain versions as
the kernel (lse 1e-4); gradients under each checkpointing policy against
'none', 1e-5 (f32, the same kernels replayed); a MAGNeT training step on
the card against the CPU, CE 1e-5 and gradients atol 1e-5 / rtol 1e-4;
Multi-Band Diffusion and JASCO solver steps on the card against the CPU
with the same draws, loss rtol 1e-4 and each gradient within 1e-4 of its
largest entry (f32, TF32 off), the band processor's statistics within
1e-5 of each one's largest entry (a band's mean is near 0); the codec
trainer's discriminators on the card against the CPU, atol 1e-4 x max(1,
max |CPU|), and one `CompressionSolver` step (k-means on its first batch,
no discriminator update), every metric rtol 1e-4 (atol 1e-6), each
gradient's L2 error within 1e-3 of its L2 norm, the codebooks atol 1e-4;
one discriminator update, its loss rtol 1e-5 and its weights within 2 x lr
(Adam's first step is about lr x sign(g)); the loudness loss's biquad in
f32 within 1e-5 of its peak, and in f64 against the sequential filter
within 1e-10; the TF loudness ratio and its gradient rtol 1e-4; two
`WatermarkSolver` steps, metrics rtol 1e-4 and gradients within 1e-3 of
their L2 norm; the CLAP towers atol 1e-5; DAC's codes equal and its decode
as MBD's; a `MusicGenSolver` step from a datasource, its batch equal and
its CE rtol 1e-5 and gradients atol 1e-5 / rtol 1e-4; the evaluation
towers under PyTorch's TF32 defaults (they turn TF32 off themselves):
VGGish embeddings and PaSST probabilities relative L2 1e-4, CLAP text
consistency atol 1e-5; a sharded LM step on a one-rank NCCL group against
the plain step, CE rtol 1e-6 and weights within 2 x lr."""
import pytest
import torch

from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.models import lm as lm_module
from audiocraft_tpu_torch.models.lm import GenParams, quantize_lm_
from audiocraft_tpu_torch.models.presets import musicgen_lm
from audiocraft_tpu_torch.modules import transformer
from audiocraft_tpu_torch.modules.conditioners import (ConditioningAttributes,
                                                       LUTConditioner)
from audiocraft_tpu_torch.ops.decode_attention import (
    _DTYPE_CODES as K1_DTYPE_CODES, _launcher as k1_launcher,
    decode_attention, decode_attention_reference, length_tensor)
from audiocraft_tpu_torch.ops import quant
from audiocraft_tpu_torch.ops.flash_causal_attention import (
    flash_causal_attention, flash_causal_attention_reference)
from audiocraft_tpu_torch.ops.int4_decode_attention import (
    _DTYPE_CODES as K3_DTYPE_CODES, _launcher as k3_launcher,
    _window as k3_window, int4_decode_attention,
    int4_decode_attention_reference, quant_pack_kv)
from audiocraft_tpu_torch.solvers.builders import get_optimizer
from audiocraft_tpu_torch.solvers.musicgen import train_step
from audiocraft_tpu_torch.utils import tracing

TEXTS = ["90s rock song with loud guitars", "calm piano"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("D", [4, 64, 66, 128])
def test_cuda_kernel_matches_reference(dtype, D):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(0)
    dev = "cuda"
    B, S, H = 3, 77, 5
    q_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn(B, H, D, device=dev).to(q_dtype)
    k = torch.randn(B, S, H, D, device=dev)
    v = torch.randn(B, S, H, D, device=dev)
    scales = {}
    if dtype == "int8":
        ks = k.abs().amax(-1) / 127
        vs = v.abs().amax(-1) / 127
        k = torch.round(k / ks[..., None]).to(torch.int8)
        v = torch.round(v / vs[..., None]).to(torch.int8)
        scales = dict(k_scale=ks.to(torch.bfloat16), v_scale=vs.to(torch.bfloat16))
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for length, window in [(1, None), (40, None), (S, None), (60, 7)]:
        before = decode_attention.launches
        out = decode_attention(q, k, v, length, past_context=window, **scales)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        ref = decode_attention_reference(q, k, v, length, past_context=window,
                                         **scales)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", list(range(1, 9)))
@pytest.mark.parametrize("dtype, D", [("float32", 64), ("bfloat16", 66),
                                      ("bfloat16", 128), ("int8", 66),
                                      ("int8", 64)])
def test_cuda_kernel_every_split_count(dtype, D, n_split):
    """K1's C launcher at each cluster size 1..8 (the wrapper's choice aside)
    over windows that leave some shares empty, the length read from the
    device, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator("cuda").manual_seed(n_split)
    B, S, H = 2, 300, 3
    q_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn(B, H, D, device="cuda", generator=g).to(q_dtype)
    k = torch.randn(B, S, H, D, device="cuda", generator=g)
    v = torch.randn(B, S, H, D, device="cuda", generator=g)
    scales = {}
    if dtype == "int8":
        (k, ks), (v, vs) = (transformer.KVCache._quantize(t) for t in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for length, window in [(1, None), (37, None), (S, None), (290, 64),
                           (200, 0)]:
        out = torch.empty_like(q)
        device_length = length_tensor(length, "cuda")
        err = k1_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            scales["k_scale"].data_ptr() if scales else None,
            scales["v_scale"].data_ptr() if scales else None, out.data_ptr(),
            device_length.data_ptr(), B, S, H, D,
            -1 if window is None else window, K1_DTYPE_CODES[q.dtype],
            K1_DTYPE_CODES[k.dtype],
            torch.cuda.current_stream().cuda_stream, n_split)
        assert err == 0
        torch.cuda.synchronize()
        ref = decode_attention_reference(q, k, v, length, past_context=window,
                                         **scales)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [None, 7])
def test_cuda_kernel_device_length_in_a_graph(dtype, window):
    """K1 captured once into a CUDA graph with a device length; each replay
    adds one to the length on the device, from 1 to S, and every output is
    held against the plain version at that length."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator("cuda").manual_seed(1)
    B, S, H, D = 4, 100, 16, 64
    q_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.randn(B, H, D, device="cuda", generator=g).to(q_dtype)
    k = torch.randn(B, S, H, D, device="cuda", generator=g)
    v = torch.randn(B, S, H, D, device="cuda", generator=g)
    scales = {}
    if dtype == "int8":
        (k, ks), (v, vs) = (transformer.KVCache._quantize(t) for t in (k, v))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    length = torch.zeros(1, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: build, shared-memory attribute
        decode_attention(q, k, v, length + 1, past_context=window, **scales)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        length.add_(1)
        out = decode_attention(q, k, v, length, past_context=window, **scales)
    torch.cuda.current_stream().wait_stream(side)
    for step in range(1, S + 1):
        graph.replay()
        torch.cuda.synchronize()
        assert int(length) == step
        ref = decode_attention_reference(q, k, v, step, past_context=window,
                                         **scales)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", list(range(1, 9)))
@pytest.mark.parametrize("D, S", [(32, 301), (64, 504), (128, 300)])
def test_int4_kernel_every_split_count(D, S, n_split):
    """K3's C launcher at each cluster size 1..8, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator("cuda").manual_seed(n_split)
    B, H = 2, 3
    k, v = (torch.randn(B, S, H, D, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
    packed = quant_pack_kv(k, v)
    for length, window in [(1, None), (37, None), (S, None), (290, 64),
                           (200, 0)]:
        lo, hi = k3_window(length, window)
        out = torch.empty_like(q)
        err = k3_launcher()(
            q.data_ptr(), *(t.data_ptr() for t in packed), out.data_ptr(),
            B, S, H, D, lo, hi, K3_DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream, n_split)
        assert err == 0
        torch.cuda.synchronize()
        ref = int4_decode_attention_reference(q, *packed, length,
                                              window).float()
        err = (out.float() - ref).abs()
        assert bool((err <= 1e-2 * ref.abs().clamp_min(1.0)).all()), \
            (length, window, err.max().item())


@pytest.mark.gpu
def test_int4_kernel_takes_a_window_past_the_old_cap():
    """30,000 valid slots: above the 28,672 the kernel once held in shared
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator("cuda").manual_seed(0)
    B, S, H, D = 2, 30_000, 4, 64
    k, v = (torch.randn(B, S, H, D, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
    packed = quant_pack_kv(k, v)
    out = int4_decode_attention(q, *packed, S)
    ref = int4_decode_attention_reference(q, *packed, S).float()
    err = (out.float() - ref).abs()
    assert bool((err <= 1e-2 * ref.abs().clamp_min(1.0)).all()), err.max()


@pytest.mark.gpu
def test_debug_musicgen_on_card_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    mg = MusicGen.get_pretrained("debug")
    mg.set_generation_params(duration=0.5)
    before = decode_attention.launches
    wav, tok = mg.generate(TEXTS, return_tokens=True)
    torch.cuda.synchronize()
    S = len(mg.lm.pattern_provider.get_pattern(12).layout)
    assert decode_attention.launches - before == mg.lm.num_layers * (S - 1)
    assert wav.shape == (2, 1, 12 * 1280) and torch.isfinite(wav).all()
    assert int(tok.min()) >= 0 and int(tok.max()) < 400


@pytest.mark.gpu
def test_greedy_tokens_on_card_match_cpu():
    """f32 debug model, greedy: the card (kernel) and the CPU (plain
    version) give the same tokens over f32 and int8 caches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = builders.get_debug_lm_model(device="cpu")
    gpu = builders.get_debug_lm_model(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    for cache_dtype in (torch.float32, torch.int8):
        kw = dict(conditions=attrs, max_gen_len=16, cache_dtype=cache_dtype,
                  gen=GenParams(use_sampling=False))
        a = cpu.generate(device="cpu", **kw)
        b = gpu.generate(device="cuda", **kw).cpu()
        assert torch.equal(a, b), cache_dtype


# an f32 amax whose quotient by 127 and product with the f32 reciprocal of
# 127 round to different bf16 values (found by search over [1, 2); any power
# of two times it behaves alike)
RECIPROCAL_SENSITIVE_AMAX = 1.9921265840530396


@pytest.mark.gpu
def test_int8_cache_on_card_equals_cpu_bit_for_bit():
    """Eight decode steps' K/V chunks of the debug LM's shape written through
    `KVCache.write` at the device offset, on the card and on the CPU: the int8
    values, the bf16 scales and the index are equal bit for bit. Half the
    rows have an amax at which dividing by the Python number 127 on the card
    (a product with its reciprocal) would give another bf16 scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    B, S, H, D = 4, 12, 4, 4
    g = torch.Generator().manual_seed(0)
    caches = {dev: transformer.KVCache.create(B, S, H, D, torch.int8, dev)
              for dev in ("cpu", "cuda")}
    for step in range(8):
        k, v = (torch.rand(B, 1, H, D, generator=g) * 2 - 1 for _ in range(2))
        for x in (k, v):  # rows of even h: amax = the sensitive value * 2^e
            peak = RECIPROCAL_SENSITIVE_AMAX * 2.0 ** (step % 5 - 2)
            x[:, :, ::2] *= peak / 2
            x[:, :, ::2, step % D] = peak
        for dev, cache in caches.items():
            cache.write(k.to(dev), v.to(dev))
    cpu, card = caches["cpu"], caches["cuda"]
    for name in ("k", "v", "k_scale", "v_scale", "index"):
        a, b = getattr(cpu, name), getattr(card, name).cpu()
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("D", [192, 256])
def test_causal_self_attention_with_head_dims_k2_lacks_runs_on_card(D):
    """A causal transformer with head dim 192 or 256 (which K2 does not
    take) runs on the card through the plain attention and matches the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    cpu = transformer.StreamingTransformer(2 * D, 2, 1, dim_feedforward=64,
                                           causal=True).eval()
    card = transformer.StreamingTransformer(2 * D, 2, 1, dim_feedforward=64,
                                            causal=True, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 300, 2 * D)
    before = flash_causal_attention.launches
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    assert flash_causal_attention.launches == before
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_sampled_tokens_on_card_repeat_with_the_seed_and_stay_in_top_k():
    """Top-k sampling through the decode graph: two runs with one seed give
    the same tokens, every sampled token is among the k most likely of the
    teacher-forced logits, and some step departs from the argmax."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = builders.get_debug_lm_model(device="cuda")
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    k = 5
    runs = [lm.generate(conditions=attrs, max_gen_len=24,
                        gen=GenParams(top_k=k),
                        generator=torch.Generator("cuda").manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    codes = runs[0]
    pattern = lm.pattern_provider.get_pattern(codes.shape[-1])
    seq, _, mask = pattern.build_pattern_sequence(codes, lm.special_token_id)
    with torch.no_grad():
        logits = lm(torch.cat([seq, seq]), lm.prepare_cfg_conditions(attrs))
    logits = logits[2:] + (logits[:2] - logits[2:]) * lm.cfg_coef
    top = torch.topk(logits, k, dim=-1).indices  # [B, K, S, k]
    for s in range(1, seq.shape[-1]):
        for q in mask[:, s].nonzero()[0]:
            tok = seq[:, q, s]
            assert (top[:, q, s - 1] == tok[:, None]).any(-1).all(), (s, q)
    assert not torch.equal(seq[:, :, 1:], logits.argmax(-1)[:, :, :-1])


@pytest.mark.gpu
def test_decode_graph_replays_every_step_after_the_warm_up():
    """A debug generate on the card captures one step and replays it for
    every offset after the prefill and the eager warm-up step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    lm = builders.get_debug_lm_model(device="cuda")
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    stats = lm_module.decode_graph_stats
    captures = stats.captures
    lm.generate(conditions=attrs, max_gen_len=16,
                gen=GenParams(use_sampling=False))
    S = len(lm.pattern_provider.get_pattern(16).layout)
    assert stats.captures == captures + 1
    assert stats.last_replays[2] == S - 3  # S - 1 forwards: 2 eager


@pytest.mark.gpu
def test_decode_spans_time_the_replays_with_the_stats_events():
    """With tracing on, a debug generate on the card gives the decode
    graph's spans in order; `lm.replays` reads the same CUDA events as
    `decode_graph_stats`, device spans have events, the root counts the
    allocator's calls; and a device span entered while the stream captures
    a graph records no event."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    lm = builders.get_debug_lm_model(device="cuda")
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    stats = lm_module.decode_graph_stats
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("generate"):
            lm.generate(conditions=attrs, max_gen_len=16,
                        gen=GenParams(use_sampling=False))
        torch.cuda.synchronize()
        x = torch.zeros(8, device="cuda")
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1)  # warm-up outside the graph
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            with tracing.span("captured", device=True) as captured:
                x.add_(1)
        graph.replay()
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    root = tracing.roots()[0]
    assert set(root.counters) == {"num_device_alloc", "num_device_free"}
    names = [c.name for c in root.children]
    assert names == ["lm.conditions", "lm.prefill", "lm.decode"]
    conditions, prefill, decode = root.children
    assert [c.name for c in decode.children] == [
        "lm.warmup_step", "lm.graph.sync", "lm.graph.release",
        "lm.graph.capture", "lm.replays"]
    assert conditions.device_ms > 0 and prefill.device_ms > 0
    capture, replays = decode.children[3:]
    assert capture.host_ms == pytest.approx(stats.last_capture_s * 1e3,
                                            abs=1e-6)
    count = stats.last_replays[2]
    assert replays.attrs == {"steps": count}
    assert replays.device_ms == pytest.approx(
        stats.last_replay_ms_per_step() * count, rel=1e-6)
    assert captured.device_ms is None and x[0].item() == 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, H, T, D", [
    (2, 3, 1, 64), (2, 3, 63, 64), (2, 3, 64, 64), (2, 3, 65, 64),
    (2, 3, 127, 64), (2, 3, 128, 64), (2, 3, 129, 64), (2, 3, 130, 64),
    (2, 3, 301, 128),
    # B * H blocks per tile row beyond the card's 132 SMs: more than one wave
    (9, 16, 129, 64), (9, 16, 257, 128)])
@pytest.mark.parametrize("fused", [False, True])
def test_flash_causal_kernel_matches_reference(dtype, B, H, T, D, fused):
    """Forward and dq, dk, dv against the plain version at the edges of the
    kernels' 64- and 128-row tiles, ragged T included; `fused` feeds q, k, v
    as strided chunks of one [B, T, 3HD] tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(0)
    dt = getattr(torch, dtype)
    if fused:
        x = torch.randn(B, T, 3 * H * D, device="cuda").to(dt).requires_grad_()
        q, k, v = (t.reshape(B, T, H, D) for t in x.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(B, T, H, D, device="cuda").to(dt).requires_grad_()
                   for _ in range(3))
    dout = torch.randn(B, T, H, D, device="cuda").to(dt)
    before = (flash_causal_attention.launches,
              flash_causal_attention.backward_launches)
    out = flash_causal_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_causal_attention.launches,
            flash_causal_attention.backward_launches) == (before[0] + 1,
                                                          before[1] + 1)
    refs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = flash_causal_attention_reference(*refs)[0]
    ref_grads = torch.autograd.grad(ref, refs, dout.float())
    out_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    torch.testing.assert_close(out.float(), ref, atol=out_tol, rtol=out_tol)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want, atol=grad_tol,
                                   rtol=grad_tol)


@pytest.mark.gpu
@pytest.mark.parametrize("T, D", [(1501, 64), (300, 128)])
def test_flash_causal_backward_is_bit_identical_across_calls(T, D):
    """The backward keeps dQ out of float atomics: two calls on the same
    inputs give the same dq, dk, dv bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(0)
    B, H = 2, 16
    x = torch.randn(B, T, 3 * H * D, device="cuda").bfloat16().requires_grad_()
    q, k, v = (t.reshape(B, T, H, D) for t in x.chunk(3, dim=-1))
    dout = torch.randn(B, T, H, D, device="cuda").bfloat16()
    first = torch.autograd.grad(flash_causal_attention(q, k, v), (q, k, v), dout)
    second = torch.autograd.grad(flash_causal_attention(q, k, v), (q, k, v), dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_causal_kernel_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q = torch.randn(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_causal_attention(q, q, q)
    q = torch.randn(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_causal_attention(q, q, q)


@pytest.mark.gpu
def test_bf16_train_step_on_card_runs_the_kernel_on_bf16(monkeypatch):
    """A small K2-eligible LM under bf16 autocast: every self-attention
    forward and backward launches K2 on bf16 q/k/v."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    seen = []

    def spy(q, k, v):
        seen.append(q.dtype)
        return flash_causal_attention(q, k, v)
    monkeypatch.setattr(transformer, "flash_causal_attention", spy)
    torch.manual_seed(0)
    cond = {"description": LUTConditioner(n_bins=256, dim=128, output_dim=128,
                                          device="cuda")}
    lm = musicgen_lm("xsmall", card=64, dim=128, num_heads=2,
                     conditioners=cond, device="cuda")
    opt = get_optimizer(lm.parameters(), {"lr": 1e-3, "max_norm": 1.0})
    codes = torch.randint(0, 64, (2, 4, 100), device="cuda")
    tokenized = lm.condition_provider.tokenize(
        [ConditioningAttributes(text={"description": t}) for t in TEXTS])
    before = (flash_causal_attention.launches,
              flash_causal_attention.backward_launches)
    ces = [train_step(lm, opt, codes, tokenized,
                      compute_dtype=torch.bfloat16)["ce"].item()
           for _ in range(3)]
    assert seen == [torch.bfloat16] * 6
    assert flash_causal_attention.launches - before[0] == 6
    assert flash_causal_attention.backward_launches - before[1] == 6
    assert all(torch.isfinite(torch.tensor(ces))) and ces[-1] < ces[0]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [41, 77, 504])
def test_int4_kernel_matches_reference(q_dtype, D, S):
    """K3 against its plain version; S = 41 and 77 take the byte-wide V
    loads (S % 4 != 0), 504 the 4-byte ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator("cuda").manual_seed(0)
    B, H = 3, 5
    k, v = (torch.randn(B, S, H, D, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g).to(
        getattr(torch, q_dtype))
    packed = quant_pack_kv(k, v)
    for length, window in [(1, None), (33, None), (S, None), (S, 7), (30, 0)]:
        before = int4_decode_attention.launches
        out = int4_decode_attention(q, *packed, length, window)
        torch.cuda.synchronize()
        assert int4_decode_attention.launches == before + 1
        ref = int4_decode_attention_reference(q, *packed, length,
                                              window).float()
        assert out.dtype == q.dtype
        err = (out.float() - ref).abs()
        assert bool((err <= 1e-2 * ref.abs().clamp_min(1.0)).all()), \
            (length, window, err.max().item())


@pytest.mark.gpu
def test_int4_kernel_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    k = torch.randn(1, 8, 2, 16, device="cuda").bfloat16()
    q = torch.randn(1, 2, 16, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        int4_decode_attention(q, *quant_pack_kv(k, k), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2, 17, 64])
def test_w8a8_dot_on_card_equals_cpu_int32_sums(M):
    """The card's int8 product (rows padded to 17 below that) gives the
    CPU's int32 sums bit for bit, and the same rescaled output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, 1024, generator=g)
    w = torch.randn(3072, 1024, generator=g) * 0.05
    qt = quant.quantize_weight(w)
    xq, _ = quant.quantize_acts(x)
    cpu = quant.int_mm(xq, qt.w.t())
    card = quant.int_mm(xq.cuda(), qt.w.cuda().t()).cpu()
    assert card.shape == (M, 3072) and torch.equal(card, cpu)
    qt_cuda = quant.QTensor(qt.w.cuda(), qt.scale.cuda(), qt.dtype)
    torch.testing.assert_close(quant.w8a8_dot(x.cuda(), qt_cuda).cpu(),
                               quant.w8a8_dot(x, qt), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["two_step", "w8a8"])
def test_serving_variant_tokens_on_card_match_cpu(mode):
    """f32 debug model, greedy: two-step CFG and W8A8 give the CPU's tokens
    on the card, where every single-step forward launches K1 per stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = builders.get_debug_lm_model(device="cpu")
    gpu = builders.get_debug_lm_model(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    if mode == "w8a8":
        quantize_lm_(cpu)
        quantize_lm_(gpu)
    gen = GenParams(use_sampling=False, two_step_cfg=mode == "two_step")
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    kw = dict(conditions=attrs, max_gen_len=16, gen=gen)
    a = cpu.generate(device="cpu", **kw)
    before = decode_attention.launches
    b = gpu.generate(device="cuda", **kw).cpu()
    S = len(gpu.pattern_provider.get_pattern(16).layout)
    streams = 2 if mode == "two_step" else 1
    assert decode_attention.launches - before == \
        gpu.num_layers * (S - 1) * streams
    assert torch.equal(a, b)


# ------------------------------------------------------- melody (slice C)

def _melody(seconds: float, sample_rate: int = 44100) -> torch.Tensor:
    """[2, 2, T] harmonic tones at two seeded pitches."""
    t = torch.arange(int(seconds * sample_rate)) / sample_rate
    rows = [sum(0.3 / h * torch.sin(2 * torch.pi * h * f0 * t)
                for h in (1, 2, 3)) for f0 in (261.6, 392.0)]
    return torch.stack(rows)[:, None].repeat(1, 2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B, S", [(4, 748), (6, 748), (2, 748), (2, 506),
                                  (4, 254)])
def test_cuda_kernel_at_melody_and_audiogen_shapes(B, S):
    """K1 at 24 heads over the capacities a melody request (pattern steps
    plus the prepended chroma and text) and AudioGen at 10 s give, with the
    length on the device at S / 8, S / 2 and S."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(B * S)
    H, D = 24, 64
    q = torch.randn(B, H, D, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    for length in (S // 8, S // 2, S):
        out = decode_attention(q, k, v, length_tensor(length, "cuda"))
        ref = decode_attention_reference(q, k, v, length)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2, length


@pytest.mark.gpu
def test_htdemucs_at_full_width_on_card_matches_cpu():
    """The published htdemucs configuration, seeded, on one 7.8 s segment
    of 44.1 kHz stereo."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audiocraft_tpu_torch.modules.demucs import HTDemucs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cpu = HTDemucs().eval()
    gpu = HTDemucs().to("cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    mix = _melody(7.8)[:1]
    with torch.no_grad():
        want = cpu(mix)
        got = gpu(mix.to("cuda")).cpu()
    assert got.shape == want.shape == (1, 4, 2, mix.shape[-1])
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["batched", "two_step", "double"])
def test_debug_melody_tokens_on_card_match_cpu(mode):
    """f32 debug melody model, greedy: the card's tokens equal the CPU's
    under each CFG mode; every single-step forward launches K1 per stream
    (the prefill, behind the chroma, is not one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"batched": {}, "two_step": {"two_step_cfg": True},
          "double": {"cfg_coef_beta": 5.0}}[mode]
    models = {}
    for device in ("cpu", "cuda"):
        mg = MusicGen.get_pretrained("debug-melody", device=device)
        mg.set_generation_params(duration=0.5, use_sampling=False, **kw)
        models[device] = mg
    models["cuda"].lm.load_state_dict(models["cpu"].lm.state_dict())
    melody = _melody(0.8)
    a = models["cpu"].generate_with_chroma(TEXTS, melody, 44100,
                                           return_tokens=True)[1]
    before = decode_attention.launches
    b = models["cuda"].generate_with_chroma(TEXTS, melody, 44100,
                                            return_tokens=True)[1].cpu()
    lm = models["cuda"].lm
    S = len(lm.pattern_provider.get_pattern(12).layout)
    streams = 2 if mode == "two_step" else 1
    assert decode_attention.launches - before == lm.num_layers * (S - 2) * streams
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_decode_graph_with_a_prefix_equals_eager_steps():
    """With the chroma prepended, the replayed graph's greedy tokens equal
    the same step run eagerly on the card, in one stream and in two of
    different capacities."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    mg = MusicGen.get_pretrained("debug-melody", device="cuda")
    melody = _melody(0.8)
    for kw in ({}, {"two_step_cfg": True}):
        mg.set_generation_params(duration=1, use_sampling=False, **kw)
        graph = mg.generate_with_chroma(TEXTS, melody, 44100,
                                        return_tokens=True)[1]
        replay = lm_module._replay_decode_steps
        lm_module._replay_decode_steps = (
            lambda step, steps, device, generator: [step() for _ in range(steps)])
        try:
            eager = mg.generate_with_chroma(TEXTS, melody, 44100,
                                            return_tokens=True)[1]
        finally:
            lm_module._replay_decode_steps = replay
        assert torch.equal(graph, eager)


# ------------------------------------------- style and MAGNeT (slices C, D)

@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 6])
def test_cuda_kernel_at_style_shapes(B):
    """K1 at 24 heads over a 10 s MusicGen-Style request's capacity: 504
    pattern steps plus 15 style and 9 text tokens prepended; batched CFG
    (B 4) and double CFG (B 6); the length on the device at S / 8, S / 2
    and S."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(B)
    H, D, S = 24, 64, 504 + 15 + 9
    q = torch.randn(B, H, D, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    for length in (S // 8, S // 2, S):
        out = decode_attention(q, k, v, length_tensor(length, "cuda"))
        ref = decode_attention_reference(q, k, v, length)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2, length


def _style_wav(seconds: float) -> torch.Tensor:
    return _melody(seconds, 32000)[:, :1] * 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["batched", "double"])
def test_debug_style_tokens_on_card_match_cpu(mode):
    """f32 debug style model, greedy, TF32 off: the card's tokens equal the
    CPU's; every single-step forward launches K1 (the prefill, behind the
    style token, is not one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"batched": {}, "double": {"cfg_coef_beta": 5.0}}[mode]
    models = {}
    for device in ("cpu", "cuda"):
        mg = MusicGen.get_pretrained("debug-style", device=device)
        mg.set_generation_params(duration=0.5, use_sampling=False, **kw)
        models[device] = mg
    # seeded inits draw from each device's own generator: share the CPU's
    for name in ("lm", "compression_model"):
        getattr(models["cuda"], name).load_state_dict(
            getattr(models["cpu"], name).state_dict())
    styles = [m.lm.condition_provider.conditioners["self_wav"]
              for m in (models["cpu"], models["cuda"])]
    styles[1].feat_extractor.load_state_dict(
        styles[0].feat_extractor.state_dict())
    tokens = {}
    for device, mg in models.items():
        before = decode_attention.launches
        tokens[device] = mg.generate_with_chroma(
            TEXTS, _style_wav(0.04), 32000, return_tokens=True)[1].cpu()
    lm = models["cuda"].lm
    S = len(lm.pattern_provider.get_pattern(12).layout)
    assert decode_attention.launches - before == lm.num_layers * (S - 2)
    assert torch.equal(tokens["cpu"], tokens["cuda"])


STYLE_TEXT_PREPEND_CFG = {
    "transformer_lm": {"n_q": 4, "card": 400, "dim": 16, "num_heads": 4,
                       "num_layers": 2, "hidden_scale": 4, "causal": True},
    "conditioners": {
        "description": {"model": "lut", "lut": {
            "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}},
        "self_wav": {"model": "style", "style": {
            "model_name": "encodec", "transformer_scale": "xsmall",
            "sample_rate": 32000, "encodec_n_q": 4, "length": 0.2,
            "ds_factor": 2, "n_q_out": 3, "eval_q": 2, "bins": 64}}},
    "fuser": {"prepend": ["self_wav", "description"], "cross": [],
              "sum": [], "input_interpolate": []},
    "classifier_free_guidance": {"inference_coef": 3.0}}


@pytest.mark.gpu
def test_style_decode_graph_with_two_prepends_equals_eager_steps():
    """Style and text both prepended (the `style2music` fuser) on a tiny
    f32 LM: the replayed graph's greedy tokens equal the same step run
    eagerly on the card, under batched and double CFG."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audiocraft_tpu_torch.modules.conditioners import bind_feat_extractor
    lm = builders.get_lm_model(STYLE_TEXT_PREPEND_CFG, device="cuda", seed=1)
    bind_feat_extractor(lm.condition_provider.conditioners["self_wav"],
                        builders.get_debug_compression_model(device="cuda"))
    codec = builders.get_debug_compression_model(device="cuda")
    mg = MusicGen("style-two-prepends", codec, lm, device="cuda")
    for kw in ({}, {"cfg_coef_beta": 5.0}):
        mg.set_generation_params(duration=1, use_sampling=False, **kw)
        graph = mg.generate_with_chroma(TEXTS, _style_wav(0.15), 32000,
                                        return_tokens=True)[1]
        replay = lm_module._replay_decode_steps
        lm_module._replay_decode_steps = (
            lambda step, steps, device, generator: [step() for _ in range(steps)])
        try:
            eager = mg.generate_with_chroma(TEXTS, _style_wav(0.15), 32000,
                                            return_tokens=True)[1]
        finally:
            lm_module._replay_decode_steps = replay
        assert torch.equal(graph, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("arrangement", ["nonoverlap", "stride1"])
def test_debug_magnet_tokens_on_card_match_cpu(arrangement):
    """f32 debug MAGNeT, greedy, TF32 off: the card's tokens equal the
    CPU's; no decode-attention kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audiocraft_tpu_torch.models import MAGNeT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, models = {}, {}
    before = decode_attention.launches
    for device in ("cpu", "cuda"):
        m = MAGNeT.get_pretrained("debug", device=device)
        m.set_generation_params(duration=0.52, use_sampling=False,
                                decoding_steps=(3, 2, 2, 2),
                                span_arrangement=arrangement)
        models[device] = m
    # seeded inits draw from each device's own generator: share the CPU's
    models["cuda"].lm.load_state_dict(models["cpu"].lm.state_dict())
    for device, m in models.items():
        tokens[device] = m.generate(TEXTS, return_tokens=True)[1].cpu()
    assert decode_attention.launches == before
    assert torch.equal(tokens["cpu"], tokens["cuda"])


@pytest.mark.gpu
def test_magnet_stage_graph_equals_eager_steps():
    """Each non-overlapping stage runs its first step eagerly and replays
    one CUDA graph of the step: greedy tokens equal the same step run
    eagerly on the card, one graph captured per stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from audiocraft_tpu_torch.models import MAGNeT
    m = MAGNeT.get_pretrained("debug", device="cuda")
    m.set_generation_params(duration=2.0, use_sampling=False,
                            decoding_steps=(6, 3, 3, 3))
    captures = lm_module.decode_graph_stats.captures
    graph = m.generate(TEXTS, return_tokens=True)[1]
    assert lm_module.decode_graph_stats.captures - captures == 4
    replay = lm_module._replay_decode_steps
    lm_module._replay_decode_steps = (
        lambda step, steps, device, generator: [step() for _ in range(steps)])
    try:
        eager = m.generate(TEXTS, return_tokens=True)[1]
    finally:
        lm_module._replay_decode_steps = replay
    assert tuple(graph.shape) == (2, 4, 48) and torch.equal(graph, eager)


def _f32_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    want = want.cpu()
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= tol


def _seeded_noise(monkeypatch, module):
    """Replace `module.randn` by draws of a seeded CPU generator, so the
    CPU and the card take the same noise."""
    g = torch.Generator().manual_seed(0)
    monkeypatch.setattr(module, "randn", lambda shape, generator, device:
                        torch.randn(tuple(shape), generator=g).to(device))
    return g


@pytest.mark.gpu
def test_debug_mbd_on_card_matches_cpu(monkeypatch):
    """2 small BiLSTM bands over the debug codec: `tokens_to_wav` on the
    card equals the CPU's with the same weights and noise."""
    _f32_card()
    from audiocraft_tpu_torch.models import MultiBandDiffusion
    from audiocraft_tpu_torch.models.multibanddiffusion import \
        DiffusionProcess
    from audiocraft_tpu_torch.modules import diffusion_schedule
    cfg = {"channels": 1,
           "diffusion_unet": dict(hidden=8, depth=2, growth=2, kernel=4,
                                  stride=2, emb_all_layers=True, bilstm=True,
                                  codec_dim=32),
           "schedule": dict(beta_t0=1e-5, beta_t1=2.9e-2, beta_exp=7.5,
                            num_steps=1000, variance="beta", clip=5.0),
           "processor": {"use": True, "n_bands": 8}}
    tokens = torch.randint(0, 400, (2, 4, 3),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", "cuda"):
        bands = []
        for band in range(2):
            model, schedule = builders.get_diffusion_band(cfg, 32000, "cpu",
                                                          seed=band)
            proc = schedule.sample_processor
            proc.counts.fill_(2.0)
            proc.sum_x2.fill_(1e-2)
            proc.sum_target_x2.fill_(1.0)
            bands.append(DiffusionProcess(model, schedule))
        codec = builders.get_debug_compression_model(device="cpu", seed=3)
        mbd = MultiBandDiffusion(bands, codec, device=device)
        with monkeypatch.context() as m:
            _seeded_noise(m, diffusion_schedule)
            out[device] = mbd.tokens_to_wav(tokens)
    assert tuple(out["cuda"].shape) == (2, 1, 3 * 1280)
    _close(out["cuda"], out["cpu"])


@pytest.mark.gpu
def test_audioseal_base_on_card_matches_cpu():
    """AudioSeal at its base widths on 1 s of 16 kHz audio: watermark and
    detection on the card equal the CPU's; probabilities sum to 1."""
    _f32_card()
    cpu = builders.get_audioseal_base(device="cpu", seed=0)
    card = builders.get_audioseal_base(device="cuda", seed=0)
    card.generator.load_state_dict(cpu.generator.state_dict())
    card.detector.load_state_dict(cpu.detector.state_dict())
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, 16000, generator=g) * 0.1
    message = torch.randint(0, 2, (2, 16), generator=g)
    _close(card.get_watermark(x, message), cpu.get_watermark(x, message))
    detected = card.detect_watermark(card.forward(x, message))
    _close(detected, cpu.detect_watermark(cpu.forward(x, message)))
    assert float((detected[:, :2].sum(1) - 1).abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("euler", [True, False], ids=["euler", "dopri5"])
def test_debug_jasco_on_card_matches_cpu(monkeypatch, euler):
    """The debug JASCO (with a chord mapping) on the card equals the CPU's
    with the same weights and noise; Dormand-Prince takes the same number
    of evaluations."""
    _f32_card()
    from audiocraft_tpu_torch.models import JASCO, flow_matching
    from audiocraft_tpu_torch.models.jasco import (CHORD_MAPPING_PATH,
                                                  load_chords_mapping)
    cpu = JASCO.get_pretrained("debug", device="cpu")
    card = JASCO.get_pretrained("debug", device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    card.compression_model.load_state_dict(cpu.compression_model.state_dict())
    out, evaluations = {}, {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        m.chords_mapping = load_chords_mapping(CHORD_MAPPING_PATH)
        m.set_generation_params(duration=0.4, euler=euler, euler_steps=8)
        count = [0]
        handle = m.model.register_forward_pre_hook(
            lambda *_: count.__setitem__(0, count[0] + 1))
        with monkeypatch.context() as mp:
            _seeded_noise(mp, flow_matching)
            out[name] = m.generate(TEXTS, chords=[("C", 0.0), ("G", 0.2)],
                                   return_tokens=True)
        handle.remove()
        evaluations[name] = count[0]
    assert evaluations["cuda"] == evaluations["cpu"]
    assert tuple(out["cuda"][0].shape) == (2, 1, 12800)
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_causal_ops_match_their_plain_versions(dtype):
    """`flash_causal_fwd` / `flash_causal_bwd` on the card against the
    plain versions on the same inputs: out, lse (f32) and dq, dk, dv, on
    the strided chunks of a fused projection; each op call launches its
    kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import sys
    ops = sys.modules["audiocraft_tpu_torch.ops.flash_causal_attention"]
    dt = getattr(torch, dtype)
    B, T, H, D = 2, 300, 4, 64
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(B, T, 3 * H * D, device="cuda", generator=g).to(dt)
    q, k, v = (t.reshape(B, T, H, D) for t in x.chunk(3, dim=-1))
    dout = torch.randn(B, T, H, D, device="cuda", generator=g).to(dt)
    before = (flash_causal_attention.launches,
              flash_causal_attention.backward_launches)
    out, lse = ops.flash_causal_fwd(q, k, v)
    grads = ops.flash_causal_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (flash_causal_attention.launches - before[0],
            flash_causal_attention.backward_launches - before[1]) == (1, 1)
    assert out.is_contiguous() and lse.dtype == torch.float32
    ref_out, ref_lse = ops.flash_causal_attention_reference(q, k, v)
    ref_grads = ops.flash_causal_attention_backward_reference(
        q.float(), k.float(), v.float(), ref_out.float(), ref_lse,
        dout.float())
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == dt and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("mode, forwards", [
    ("none", 2), ("torch", 4), ("dots", 2), ("dots_nb", 2)])
def test_selective_checkpointing_launches_on_the_card(mode, forwards):
    """A 2-layer causal stack on the card: K2's forward launches per step
    are L under 'none', 'dots' and 'dots_nb' (its outputs are saved) and
    2L under 'torch'; backward L under all; gradients equal 'none''s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _f32_card()
    x = torch.randn(2, 130, 128, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    grads = {}
    for m in ("none", mode):
        torch.manual_seed(0)
        net = transformer.StreamingTransformer(
            128, 2, 2, dim_feedforward=256, causal=True, checkpointing=m,
            device="cuda")
        net.train()
        before = (flash_causal_attention.launches,
                  flash_causal_attention.backward_launches)
        net(x).square().sum().backward()
        torch.cuda.synchronize()
        launched = (flash_causal_attention.launches - before[0],
                    flash_causal_attention.backward_launches - before[1])
        grads[m] = [p.grad for p in net.parameters()]
    assert launched == (forwards, 2)
    for a, b in zip(grads["none"], grads[mode]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 3])
def test_debug_magnet_train_step_on_card_matches_cpu(stage):
    """One MAGNeT solver step on the debug LM, the same weights, batch,
    stage and mask on the card and on the CPU: CE and every gradient."""
    _f32_card()
    import numpy as np
    from audiocraft_tpu_torch.solvers.magnet import MagnetSolver
    rs = np.random.RandomState(stage)
    codes = torch.from_numpy(rs.randint(0, 400, (2, 4, 20)))
    mask = MagnetSolver._get_mask
    out = {}
    for device in ("cpu", "cuda"):
        solver = MagnetSolver({"seed": 0, "solver": "magnet"}, device=device)
        if device == "cuda":
            solver.model.load_state_dict(out["cpu"][2])
        solver.optimizer = get_optimizer(solver.model.parameters(),
                                         {"lr": 0.0})
        stage_mask = mask(solver, np.random.RandomState(7),
                          np.array([0.6, 0.4]), 2, 20)
        tokenized = solver.model.condition_provider.tokenize(
            [ConditioningAttributes(text={"description": t}) for t in TEXTS])
        m = solver.masked_step(codes.to(device), tokenized, None, stage,
                               stage_mask)
        out[device] = (m["ce"].item(),
                       {n: p.grad.cpu() for n, p in
                        solver.model.named_parameters()},
                       {k: v.cpu() for k, v in
                        solver.model.state_dict().items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    for name, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], g, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_diffusion_solver_step_on_card_matches_cpu():
    """One Multi-Band Diffusion solver step (a small BiLSTM U-Net over the
    debug codec, 8-band processor) with the same weights, batch and draws on
    the card and on the CPU: the loss, the processor's statistics and every
    gradient."""
    _f32_card()
    from audiocraft_tpu_torch.solvers import diffusion as tdiff
    from audiocraft_tpu_torch.solvers import get_solver
    cfg = {"solver": "diffusion", "seed": 1, "sample_rate": 32000,
           "diffusion_unet": dict(hidden=8, depth=2, growth=2.0, kernel=4,
                                  stride=2, emb_all_layers=True, bilstm=True,
                                  codec_dim=32)}
    g = torch.Generator().manual_seed(2)
    x = 0.2 * torch.randn(2, 1, 5120, generator=g)
    draws = dict(ref_noise=torch.randn(x.shape, generator=g),
                 step=torch.randint(0, 1000, (2,), generator=g),
                 noise=torch.randn(x.shape, generator=g))
    out = {}
    for device in ("cpu", "cuda"):
        solver = get_solver(cfg, device=device)
        if device == "cuda":  # the CPU's weights (inits draw per device)
            solver.model.load_state_dict(weights[0])
            solver.codec.load_state_dict(weights[1])
        weights = (solver.model.state_dict(), solver.codec.state_dict())
        condition = solver.get_condition(x)
        loss, _, _ = tdiff.diffusion_loss(
            solver.model, solver.schedule, x.to(device), condition,
            **{k: v.to(device) for k, v in draws.items()})
        loss.backward()
        out[device] = (loss.item(), condition.cpu(),
                       {k: v.cpu() for k, v in
                        solver.sample_processor.state_dict().items()},
                       {n: p.grad.cpu() for n, p in
                        solver.model.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1])
    for name, value in out["cpu"][2].items():
        tol = 1e-5 * max(1e-30, float(value.abs().max()))
        assert float((out["cuda"][2][name] - value).abs().max()) <= tol, name
    for name, grad in out["cpu"][3].items():
        tol = 1e-4 * max(1e-30, float(grad.abs().max()))
        assert float((out["cuda"][3][name] - grad).abs().max()) <= tol, name


@pytest.mark.gpu
def test_jasco_solver_step_on_card_matches_cpu():
    """One JASCO solver step on the debug model, the same weights, batch, t
    and z0 on the card and on the CPU: the loss and every gradient."""
    _f32_card()
    from audiocraft_tpu_torch.solvers import get_solver
    from audiocraft_tpu_torch.solvers import jasco as tjasco
    g = torch.Generator().manual_seed(3)
    wav = 0.1 * torch.randn(2, 1, 12800, generator=g)
    t = torch.rand((2,), generator=g)
    z0 = torch.randn(2, 10, 32, generator=g)
    out = {}
    for device in ("cpu", "cuda"):
        solver = get_solver({"solver": "jasco", "seed": 0}, device=device)
        if device == "cuda":  # the CPU's weights (inits draw per device)
            solver.model.load_state_dict(weights[0])
            solver.compression_model.load_state_dict(weights[1])
        weights = (solver.model.state_dict(),
                   solver.compression_model.state_dict())
        latents, tokenized = solver._tokenize_batch(wav, None)
        loss = tjasco.flow_matching_loss(solver.model, latents, tokenized,
                                         t=t.to(device), z0=z0.to(device))
        loss.backward()
        out[device] = (loss.item(), latents.cpu(),
                       {n: p.grad.cpu() for n, p in
                        solver.model.named_parameters()
                        if p.grad is not None})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2].keys() == out["cpu"][2].keys()
    for name, grad in out["cpu"][2].items():
        tol = 1e-4 * max(1e-30, float(grad.abs().max()))
        assert float((out["cuda"][2][name] - grad).abs().max()) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["msstftd", "mpd", "msd"])
def test_codec_discriminators_on_card_match_cpu(name):
    """The MS-STFT (cuFFT), multi-period and multi-scale discriminators at
    small widths: every logit and feature map, card against CPU."""
    _f32_card()
    from audiocraft_tpu_torch import adversarial
    cls, kw = {"msstftd": (adversarial.MultiScaleSTFTDiscriminator,
                           dict(filters=4, n_ffts=(256, 128),
                                hop_lengths=(64, 32), win_lengths=(256, 128))),
               "mpd": (adversarial.MultiPeriodDiscriminator,
                       dict(filters=2, periods=(2, 3))),
               "msd": (adversarial.MultiScaleDiscriminator,
                       dict(filters=4))}[name]
    torch.manual_seed(0)
    cpu = cls(**kw)
    gpu = cls(**kw).to("cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = 0.3 * torch.randn(2, 1, 4001, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = cpu(x), gpu(x.to("cuda"))
    for w, g in zip(want[0], got[0]):
        _close(g, w)
    for wmaps, gmaps in zip(want[1], got[1]):
        for w, g in zip(wmaps, gmaps):
            _close(g, w)


@pytest.mark.gpu
def test_compression_solver_step_on_card_matches_cpu():
    """One EnCodec GAN step of `CompressionSolver` (a small weight-normed
    codec with an LSTM, k-means codebooks on its first batch, MS-STFT
    adversary, balancer) with the same weights, batch and draws (the
    solver's CPU generator) on the card and on the CPU, the discriminator's
    update left out: every metric, every generator gradient and the
    codebooks after k-means and the EMA step. Then one discriminator update
    on both from the same weights: its loss, and its weights within 2 x lr
    (Adam's first step is about lr x sign(g))."""
    import copy
    import math
    _f32_card()
    from audiocraft_tpu_torch.solvers import get_solver
    cfg = {"solver": "compression", "seed": 0, "sample_rate": 16000,
           "compression_model": "encodec", "encodec": {
               "sample_rate": 16000, "channels": 1,
               "seanet": {"dimension": 32, "n_filters": 4,
                          "n_residual_layers": 1, "ratios": [10, 8, 8],
                          "lstm": 1, "norm": "weight_norm"},
               "rvq": {"n_q": 4, "bins": 8}},
           "msstftd": {"filters": 2, "n_ffts": [128, 64],
                       "hop_lengths": [32, 16], "win_lengths": [128, 64]},
           "mel": {"n_fft": 256, "hop_length": 64, "win_length": 256,
                   "n_mels": 16},
           "msspec": {"range_start": 6, "range_end": 8, "n_mels": 8,
                      "normalized": True, "alphas": False},
           "sisnr": {"segment": 0.05}}
    g = torch.Generator().manual_seed(3)
    x = 0.2 * torch.randn(2, 1, 3200, generator=g)
    fake = x + 0.05 * torch.randn(x.shape, generator=g)
    out = {}
    for device in ("cpu", "cuda"):
        solver = get_solver(cfg, device=device)
        if device == "cuda":  # the CPU's weights (inits draw per device)
            solver.model.load_state_dict(weights[0])
            solver.adv_losses["msstftd"].adversary.load_state_dict(weights[1])
        weights = copy.deepcopy((
            solver.model.state_dict(),
            solver.adv_losses["msstftd"].adversary.state_dict()))
        solver.disc_every = math.inf
        metrics = solver.run_step(0, x, {})
        adv = solver.adv_losses["msstftd"]
        d_loss = adv.train_adv(fake.to(device), x.to(device))
        out[device] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in solver.model.named_parameters()},
            {k: v.cpu() for k, v in solver.model.quantizer.state_dict().items()},
            float(d_loss),
            {k: v.cpu() for k, v in adv.adversary.state_dict().items()})
    assert out["cpu"][0]["d_loss"] == 0.0
    for key, value in out["cpu"][0].items():
        assert abs(out["cuda"][0][key] - value) <= 1e-4 * abs(value) + 1e-6, key
    for name, grad in out["cpu"][1].items():
        err = float((out["cuda"][1][name] - grad).norm())
        assert err <= 1e-3 * float(grad.norm()), name
    for name, value in out["cpu"][2].items():
        assert float((out["cuda"][2][name] - value).abs().max()) <= 1e-4, name
    assert abs(out["cuda"][3] - out["cpu"][3]) <= 1e-5 * abs(out["cpu"][3])
    for name, value in out["cpu"][4].items():
        assert float((out["cuda"][4][name] - value).abs().max()) <= 6e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["treble", "highpass"])
def test_biquad_on_card_matches_cpu(name):
    """The chunked biquad of the loudness loss on the TF-loudness shapes
    (rows of 8000 samples at 16 kHz): f32 on the card against the CPU
    within 1e-5 of the peak, and f64 on the card against the sequential
    filter (a loop over samples on the CPU) within 1e-10."""
    import math
    _f32_card()
    from audiocraft_tpu_torch.losses import loudnessloss
    if name == "treble":
        w0, Q, A = 2 * math.pi * 1500 / 16000, 1 / math.sqrt(2), 10 ** 0.1
        alpha = math.sin(w0) / 2 / Q
        t1, t2, t3 = 2 * math.sqrt(A) * alpha, (A - 1) * math.cos(w0), \
            (A + 1) * math.cos(w0)
        coeffs = (A * ((A + 1) + t2 + t1), -2 * A * ((A - 1) + t3),
                  A * ((A + 1) + t2 - t1), (A + 1) - t2 + t1,
                  2 * ((A - 1) - t3), (A + 1) - t2 - t1)
    else:
        w0 = 2 * math.pi * 38 / 16000
        alpha = math.sin(w0) / 2 / 0.5
        coeffs = ((1 + math.cos(w0)) / 2, -1 - math.cos(w0),
                  (1 + math.cos(w0)) / 2, 1 + alpha, -2 * math.cos(w0),
                  1 - alpha)
    x = 0.3 * torch.randn(64, 1, 8000, generator=torch.Generator().manual_seed(0))
    got = loudnessloss.biquad(x.cuda(), *coeffs)
    want = loudnessloss.biquad(x, *coeffs)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    b0, b1, b2, a0, a1, a2 = coeffs
    xs = x.double()[:4]
    ys = torch.zeros_like(xs)
    for t in range(xs.shape[-1]):
        y = b0 * xs[..., t]
        if t > 0:
            y = y + b1 * xs[..., t - 1] - a1 * ys[..., t - 1]
        if t > 1:
            y = y + b2 * xs[..., t - 2] - a2 * ys[..., t - 2]
        ys[..., t] = y / a0
    got64 = loudnessloss.biquad(xs.cuda(), *coeffs).cpu()
    assert float((got64 - ys).abs().max()) <= 1e-10 * float(ys.abs().max())


@pytest.mark.gpu
def test_loudness_ratio_on_card_matches_cpu():
    """The TF loudness ratio (4 bands, 0.5 s frames) of 8 rows of 1 s and
    its gradient on the card against the CPU, rtol 1e-4 (max-abs scaled)."""
    _f32_card()
    from audiocraft_tpu_torch.losses.loudnessloss import TFLoudnessRatio
    g = torch.Generator().manual_seed(1)
    ref = 0.3 * torch.randn(8, 1, 16000, generator=g)
    out = ref + 0.01 * torch.randn(ref.shape, generator=g)
    loss = TFLoudnessRatio(16000, segment=0.5, n_bands=4)
    res = {}
    for device in ("cpu", "cuda"):
        o = out.to(device, copy=True).requires_grad_(True)
        value = loss(o, ref.to(device))
        value.backward()
        res[device] = (float(value.detach()), o.grad.cpu())
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0])
    assert float((res["cuda"][1] - res["cpu"][1]).abs().max()) <= 1e-4 * float(
        res["cpu"][1].abs().max())


@pytest.mark.gpu
def test_watermark_solver_step_on_card_matches_cpu():
    """Two `WatermarkSolver` steps (4 bits, SEANet 16 / 2 filters, ratios
    8-4, 0.2 s at 16 kHz) from the same weights with the same draws (the
    solver's CPU generator: message, mode, mask, effect and the effect's
    noise) on the card and on the CPU: every metric rtol 1e-4 (atol 1e-6),
    each gradient's L2 error within 1e-3 of its L2 norm (plus 1e-6 of the
    largest), the parameters after Adam within 2 x lr."""
    _f32_card()
    from audiocraft_tpu_torch.solvers import get_solver
    cfg = {"solver": "watermarking", "seed": 0, "sample_rate": 16000,
           "audioseal": {"nbits": 4, "dimension": 16, "n_filters": 2,
                         "ratios": [8, 4]},
           "dataset": {"segment_duration": 0.2},
           "msspec": {"range_start": 6, "range_end": 8, "n_mels": 8},
           "tf_loudnessratio": {"segment": 0.1, "n_bands": 2}}
    x = 0.2 * torch.randn(2, 1, 3200, generator=torch.Generator().manual_seed(2))
    out = {}
    for device in ("cpu", "cuda"):
        solver = get_solver(cfg, device=device)
        steps = [solver.run_step(i, x, {}) for i in range(2)]
        models = (solver.generator, solver.detector)
        out[device] = (
            [{k: float(v) for k, v in m.items()} for m in steps],
            {f"{i}.{n}": p.grad.cpu() for i, m in enumerate(models)
             for n, p in m.named_parameters()},
            {f"{i}.{n}": p.detach().cpu() for i, m in enumerate(models)
             for n, p in m.named_parameters()})
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        for key, value in want.items():
            assert abs(got[key] - value) <= 1e-4 * abs(value) + 1e-6, key
    floor = 1e-6 * max(float(g.norm()) for g in out["cpu"][1].values())
    for name, grad in out["cpu"][1].items():
        err = float((out["cuda"][1][name] - grad).norm())
        assert err <= 1e-3 * float(grad.norm()) + floor, name
    for name, value in out["cpu"][2].items():
        assert float((out["cuda"][2][name] - value).abs().max()) <= 1e-4, name


@pytest.mark.gpu
def test_clap_towers_on_card_match_cpu():
    """A small seeded CLAP (16 mel bins, window 4, two stages; text 2
    layers of 32) on the card against the CPU: audio and text embeddings
    atol 1e-5 (unit-norm outputs)."""
    _f32_card()
    from audiocraft_tpu_torch.modules import clap
    cfg = clap.CLAPConfig(
        num_mel_bins=16, spec_size=64, patch_embeds_hidden_size=16,
        window_size=4, depths=[2, 2], num_heads=[2, 2], vocab_size=100,
        text_hidden_size=32, text_num_layers=2, text_num_heads=2,
        text_intermediate_size=64, max_position_embeddings=80,
        projection_dim=20)
    torch.manual_seed(0)
    cpu = clap.ClapModel(cfg).eval()
    card = clap.ClapModel(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    mel = 20 * torch.randn(3, 200, 16, generator=g) - 30
    ids = torch.randint(2, 100, (3, 12), generator=g)
    mask = torch.ones(3, 12, dtype=torch.long)
    ids[1, 8:], mask[1, 8:] = 1, 0
    with torch.no_grad():
        for got, want in ((card.get_audio_features(mel.cuda()),
                           cpu.get_audio_features(mel)),
                          (card.get_text_features(ids.cuda(), mask.cuda()),
                           cpu.get_text_features(ids, mask))):
            assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_dac_on_card_matches_cpu():
    """A small seeded DAC (encoder 8, strides 2-4-8, decoder 64, 4
    codebooks of 64 x 8) on the card against the CPU: codes equal and the
    decode atol 1e-4 x max(1, max |CPU|)."""
    _f32_card()
    from audiocraft_tpu_torch.models import dac
    torch.manual_seed(0)
    model = dac.DACModel(encoder_dim=8, encoder_rates=(2, 4, 8),
                         decoder_dim=64, decoder_rates=(8, 4, 2),
                         n_codebooks=4, codebook_size=64, codebook_dim=8)
    cpu = dac.DAC(model, device="cpu")
    card = dac.DAC(dac.DACModel(encoder_dim=8, encoder_rates=(2, 4, 8),
                                decoder_dim=64, decoder_rates=(8, 4, 2),
                                n_codebooks=4, codebook_size=64,
                                codebook_dim=8), device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    x = 0.3 * torch.randn(2, 1, 4410, generator=torch.Generator().manual_seed(4))
    codes, _ = cpu.encode(x)
    got_codes, _ = card.encode(x)
    assert torch.equal(got_codes.cpu(), codes)
    _close(card.decode(codes), cpu.decode(codes))


@pytest.mark.gpu
def test_musicgen_solver_step_from_a_datasource_on_card_matches_cpu(
        tmp_path):
    """`MusicGenSolver` fed from a manifest of 44.1 kHz stereo WAVs (its
    loader resamples to 32 kHz mono; pinned batches copied without
    blocking): the card's first batch equals the CPU's, and one train step
    on it gives the CPU's CE (rtol 1e-5) and gradients (atol 1e-5, rtol
    1e-4), f32, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    import numpy as np
    from audiocraft_tpu_torch.data import audio, audio_dataset
    from audiocraft_tpu_torch.solvers import get_solver
    rs = np.random.RandomState(0)
    for i in range(3):
        t = np.arange(88200) / 44100
        wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) \
            + 0.05 * rs.randn(2, t.size)
        audio.audio_write(tmp_path / f"t{i}", wav.astype(np.float32), 44100,
                          normalize=False, strategy="clip")
        (tmp_path / f"t{i}.json").write_text(json.dumps({
            "title": "T", "artist": "A", "key": "C", "bpm": 100,
            "genre": "rock", "moods": ["calm"], "name": "n",
            "instrument": "mix", "description": f"calm take {i}"}))
    audio_dataset.save_audio_meta(tmp_path / "data.jsonl",
                                  audio_dataset.find_audio_files(tmp_path))
    cfg = {"solver": "musicgen", "seed": 0, "sample_rate": 32000,
           "channels": 1, "datasource": {"train": str(tmp_path)},
           "dataset": {"batch_size": 2, "segment_duration": 1.0,
                       "num_workers": 2, "train": {"num_samples": 4}}}
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = get_solver(dict(cfg), device="cpu")
        card = get_solver(dict(cfg), device="cuda")
        card.model.load_state_dict(cpu.model.state_dict())
        card.compression_model.load_state_dict(
            cpu.compression_model.state_dict())
        batches = []
        for solver in (cpu, card):
            solver.dataloaders["train"].set_epoch(1)
            batches.append(next(iter(solver.dataloaders["train"])))
        assert batches[1][0].is_pinned()
        assert torch.equal(batches[0][0], batches[1][0])
        metrics = [s.run_step(0, b, {}) for s, b in zip((cpu, card), batches)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    torch.testing.assert_close(metrics[1]["ce"].cpu(), metrics[0]["ce"],
                               rtol=1e-5, atol=0)
    grads = dict(cpu.model.named_parameters())
    for name, p in card.model.named_parameters():
        if grads[name].grad is not None:
            torch.testing.assert_close(p.grad.cpu(), grads[name].grad,
                                       atol=1e-5, rtol=1e-4)


def _rel_l2(got, want) -> float:
    got, want = torch.as_tensor(got).cpu().double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm())


@pytest.fixture
def _tf32_on():
    """TF32 allowed around the test, as PyTorch's default for cuDNN: the
    evaluation towers must turn it off themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _eval_audio(B, seconds, sr=32000):
    g = torch.Generator().manual_seed(9)
    t = torch.arange(int(seconds * sr)) / sr
    f0 = 110.0 * 2 ** (torch.randint(0, 36, (B, 1, 1), generator=g) / 12)
    wav = torch.sin(2 * torch.pi * f0 * t) + 0.1 * torch.randn(
        B, 1, len(t), generator=g)
    return 0.3 * wav / wav.abs().max()


@pytest.mark.gpu
def test_vggish_embedder_on_card_matches_cpu(_tf32_on):
    """A narrow VGGish (convolutions 8-32, fully connected 64-64-16) on the
    card under TF32 defaults against the CPU: relative L2 <= 1e-4."""
    from audiocraft_tpu_torch.metrics.vggish import VGGish, VGGishEmbedder
    torch.manual_seed(0)
    state = VGGish((8, 16, 32, 32, 32, 32), (64, 64), 16).state_dict()
    wav = _eval_audio(2, 3.0)
    got = VGGishEmbedder(state, device="cuda")(wav.cuda(), 32000)
    want = VGGishEmbedder(state, device="cpu")(wav, 32000)
    assert got.shape == (6, 16)
    assert _rel_l2(got, want) <= 1e-4


@pytest.mark.gpu
def test_passt_classifier_on_card_matches_cpu(_tf32_on):
    """A narrow PaSST (d 128, 2 heads, 2 blocks, 16 time positions) on the
    card under TF32 defaults against the CPU, over an input that takes two
    segments: probabilities relative L2 <= 1e-4."""
    from audiocraft_tpu_torch.metrics.passt import PaSST, PasstClassifier
    torch.manual_seed(1)
    net = PaSST(dim=128, depth=2, mlp_hidden=512, time_patches=16)
    with torch.no_grad():
        for p in (net.cls_token, net.dist_token, net.freq_new_pos_embed,
                  net.time_new_pos_embed):
            p.normal_(0, 0.5)
    state = net.state_dict()
    wav = _eval_audio(2, 2.5)
    got = PasstClassifier(state, device="cuda")(wav.cuda(), 32000)
    want = PasstClassifier(state, device="cpu")(wav, 32000)
    assert _rel_l2(got, want) <= 1e-4


@pytest.mark.gpu
def test_text_consistency_on_card_matches_cpu(tmp_path, _tf32_on):
    """`CLAPTextConsistencyMetric` over a small seeded CLAP with
    character-level tokenizer files, on the card under TF32 defaults
    against the CPU: the towers' parameters on the card, the metric atol
    1e-5 (a mean of cosines)."""
    import json
    from audiocraft_tpu_torch.metrics import CLAPTextConsistencyMetric
    from audiocraft_tpu_torch.modules import clap
    from audiocraft_tpu_torch.utils import safetensors
    from audiocraft_tpu_torch.utils.utils import check_module_device
    cfg = clap.CLAPConfig(
        num_mel_bins=16, spec_size=64, patch_embeds_hidden_size=16,
        window_size=4, depths=[2, 2], num_heads=[2, 2], vocab_size=100,
        text_hidden_size=32, text_num_layers=2, text_num_heads=2,
        text_intermediate_size=64, max_position_embeddings=80,
        projection_dim=20)
    torch.manual_seed(0)
    safetensors.save_file(clap.ClapModel(cfg).state_dict(),
                          tmp_path / "clap.safetensors")
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>", "Ġ"] + [
        chr(c) for c in range(ord("a"), ord("z") + 1)]
    (tmp_path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(tokens)}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    wav, texts = _eval_audio(2, 1.0), ["warm piano", "fast drums"]
    values = {}
    for device in ("cpu", "cuda"):
        metric = CLAPTextConsistencyMetric(
            model_path=str(tmp_path / "clap.safetensors"), device=device)
        check_module_device(metric.embedder.model, torch.device(device, 0)
                            if device == "cuda" else torch.device(device))
        metric.update(wav.to(device), texts, [32000, 32000], [32000, 32000])
        values[device] = metric.compute()
    assert abs(values["cuda"] - values["cpu"]) <= 1e-5


@pytest.mark.gpu
def test_sharded_step_on_a_one_rank_nccl_group_matches_the_plain_step():
    """`parallel.shard_lm` on a one-rank NCCL group (mesh 1 x 1 x 1): two
    sharded steps of an f32 LM with one 64-wide head give the plain steps'
    CE (rtol 1e-6) and weights (within 2 x lr), every self-attention
    through K2."""
    import socket
    import numpy as np
    from torch.distributed.tensor import DTensor
    from audiocraft_tpu_torch.parallel import distrib
    from audiocraft_tpu_torch.parallel.mesh import create_mesh
    from audiocraft_tpu_torch.parallel.sharding import shard_lm
    from audiocraft_tpu_torch.solvers.musicgen import (make_optimizer,
                                                       train_step)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    def build():
        torch.manual_seed(0)
        return musicgen_lm("xsmall", n_q=4, card=64, num_heads=1,
                           num_layers=2, device="cuda")

    rs = np.random.RandomState(3)
    codes = torch.from_numpy(rs.randint(0, 64, (4, 4, 32))).cuda()
    tok = {"description": (rs.randint(0, 2048, (4, 4)),
                           np.ones((4, 4), np.int64))}
    plain = build()
    opt = make_optimizer(plain.parameters(), 1e-3)
    want = [float(train_step(plain, opt, codes, tok, dropout_seed=i)["ce"])
            for i in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distrib.init(f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                 device="cuda")
    try:
        mesh = create_mesh(dp=1, fsdp=1, tp=1)
        sharded = shard_lm(build(), mesh)
        assert all(isinstance(p, DTensor) for p in sharded.parameters())
        opt = make_optimizer(sharded.parameters(), 1e-3)
        flash_causal_attention.launches = 0
        flash_causal_attention.backward_launches = 0
        got = [float(train_step(sharded, opt, codes, tok, dropout_seed=i,
                                mesh=mesh)["ce"]) for i in range(2)]
        assert (flash_causal_attention.launches,
                flash_causal_attention.backward_launches) == (4, 4)
        for a, b in zip(got, want):
            assert abs(a - b) <= 1e-6 * abs(b), (got, want)
        ours = sharded.state_dict()
        for k, v in plain.state_dict().items():
            assert float((ours[k].to_local() - v).abs().max()) <= 2e-3, k
    finally:
        distrib.close()
