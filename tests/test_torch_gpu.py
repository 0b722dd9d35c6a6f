"""Tests that need an NVIDIA card (marker `gpu`); they skip without one.

This file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 caches 1e-4; bf16 and int8 caches 2e-2 (bf16 output
rounding of values of order 1)."""
import pytest
import torch

from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.models.lm import GenParams
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)

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
