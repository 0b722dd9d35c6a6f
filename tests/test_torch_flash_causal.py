"""The port's causal flash attention (K2) on the CPU: its plain version
against the JAX package's off-TPU route (`dot_product_attention` with
`make_causal_bias`, which `tests/ops/test_flash_attention.py` holds the Pallas
kernel against), the eligibility rule, the transformer's routing, dropout and
`checkpointing='torch'`.

Tolerance: f32, output and dQ/dK/dV atol 1e-5 (the same sums in another
order). The CUDA kernels themselves are held against the plain version on the
card (`tests/test_torch_gpu.py`, `chip_smoke.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.ops import attention as jattn
from audiocraft_tpu_torch.modules import transformer as ttr
from audiocraft_tpu_torch.ops.attention import (dot_product_attention, dropout,
                                                flash_causal_eligible)
from audiocraft_tpu_torch.ops.flash_causal_attention import (
    flash_causal_attention, flash_causal_attention_reference)


def _jax_causal(q, k, v):
    pos = jnp.arange(q.shape[1])
    return jattn.dot_product_attention(q, k, v,
                                       bias=jattn.make_causal_bias(pos, pos))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 37, 300])
def test_plain_version_and_its_gradients_match_jax(T, D):
    rs = np.random.RandomState(T + D)
    q, k, v, do = (rs.randn(2, T, 2, D).astype(np.float32) for _ in range(4))
    expected, vjp = jax.vjp(_jax_causal, q, k, v)
    grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_causal_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected),
                               atol=1e-5, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_cpu_tensors_take_the_plain_version_and_no_launch():
    q = torch.randn(1, 9, 2, 64)
    before = (flash_causal_attention.launches,
              flash_causal_attention.backward_launches)
    assert torch.equal(flash_causal_attention(q, q, q),
                       flash_causal_attention_reference(q, q, q))
    assert (flash_causal_attention.launches,
            flash_causal_attention.backward_launches) == before


def test_other_devices_raise_rather_than_fall_back():
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        flash_causal_attention(q, q, q)


@pytest.mark.parametrize("case, match", [
    ("head_dim_32", "head dims"), ("float16", "float32 or all bfloat16"),
    ("mixed_dtypes", "float32 or all bfloat16"), ("shapes", "one shape"),
    ("row_stride", "16-byte aligned"), ("head_dim_strided", "contiguous")])
def test_the_cuda_route_rejects_what_the_kernel_cannot_take(case, match):
    """The checks `flash_causal_attention` runs before a launch read only
    shapes, dtypes and strides, so they are exercised here on CPU tensors."""
    from audiocraft_tpu_torch.ops.flash_causal_attention import _check_cuda
    q = torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16)
    k = v = q
    if case == "head_dim_32":
        q = k = v = torch.zeros(2, 5, 3, 32, dtype=torch.bfloat16)
    elif case == "float16":
        q = k = v = q.half()
    elif case == "mixed_dtypes":
        k = q.float()
    elif case == "shapes":
        k = torch.zeros(2, 6, 3, 64, dtype=torch.bfloat16)
    elif case == "row_stride":  # rows 3 * 64 + 4 elements apart
        q = k = v = torch.zeros(2, 5, 3 * 64 + 4, dtype=torch.bfloat16)[
            ..., :192].reshape(2, 5, 3, 64)
    elif case == "head_dim_strided":
        q = k = v = torch.zeros(2, 5, 3, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match=match):
        _check_cuda(q, k, v)
    _check_cuda(*(torch.zeros(2, 5, 3 * 64 * 3, dtype=torch.bfloat16)
                  .reshape(2, 5, 9, 64).split(3, dim=2)))  # fused chunks pass


@pytest.mark.parametrize("q_len, k_len, head_dim, eligible", [
    (1500, 1500, 64, True), (2, 2, 64, True), (1, 1, 128, True),
    (300, 300, 192, False), (300, 300, 256, False), (300, 301, 64, False),
    (1, 300, 64, False),
    (300, 300, 32, False), (300, 300, 96, False), (300, 300, 16, False)])
def test_eligibility_truth_table(q_len, k_len, head_dim, eligible):
    assert flash_causal_eligible(q_len, k_len, head_dim) is eligible


def _count_flash(monkeypatch):
    calls = []

    def counting(q, k, v):
        calls.append((q.dtype, q.shape))
        return flash_causal_attention(q, k, v)
    monkeypatch.setattr(ttr, "flash_causal_attention", counting)
    return calls


@pytest.mark.parametrize("case, routed", [
    ("eligible", True), ("eligible_train_no_dropout", True),
    ("past_context", False), ("attention_as_float32", False),
    ("train_attention_dropout", False), ("head_dim_32", False),
    ("not_causal", False), ("cache", False)])
def test_transformer_routes_causal_self_attention_to_the_kernel(
        monkeypatch, case, routed):
    """The JAX package's conditions (`modules/transformer.py:355-379`):
    causal, no past_context, no cache, not attention_as_float32, and no
    attention dropout in training; plus the eligibility rule."""
    calls = _count_flash(monkeypatch)
    kw = dict(embed_dim=128, num_heads=2, causal=True)
    if case == "past_context":
        kw["past_context"] = 8
    elif case == "attention_as_float32":
        kw["attention_as_float32"] = True
    elif case == "train_attention_dropout":
        kw["dropout"] = 0.1
    elif case == "head_dim_32":
        kw["num_heads"] = 4
    elif case == "not_causal":
        kw["causal"] = False
    mha = ttr.StreamingMultiheadAttention(**kw)
    mha.train(case.startswith("train") or case == "eligible_train_no_dropout")
    x = torch.randn(2, 10, 128)
    if case == "cache":
        cache = ttr.KVCache.create(2, 16, 2, 64)
        mha(x, cache=cache)
    else:
        mha(x)
    assert bool(calls) is routed
    if routed:
        assert calls == [(torch.float32, (2, 10, 2, 64))]


def test_dropout_statistics():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(y.mean().item() - 1.0) < 0.01
    assert dropout(x, 0.0, g) is x


def test_attention_probs_dropout_statistics():
    """Inverted dropout after the softmax: a fraction p of the weights is
    zeroed, and on average each output is the undropped one."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(64, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    ref = dot_product_attention(q, k, v)
    g = torch.Generator().manual_seed(1)
    runs = torch.stack([dot_product_attention(q, k, v, dropout_rate=0.3,
                                              generator=g) for _ in range(400)])
    assert not torch.allclose(runs[0], ref)
    assert (runs.mean(0) - ref).abs().mean().item() < 0.02
    vv = torch.eye(8)[None, :, None, :].expand(1, 8, 1, 8)  # out = weights
    w = dot_product_attention(q[:1, :, :1], k[:1, :, :1], vv, dropout_rate=0.3,
                              generator=g)
    assert 0.15 < (w == 0).float().mean().item() < 0.45


def _layer_stack(p: float, checkpointing: str = "none"):
    torch.manual_seed(0)
    return ttr.StreamingTransformer(128, 2, 2, dim_feedforward=256, dropout=p,
                                    causal=True, cross_attention=True,
                                    checkpointing=checkpointing)


def test_training_dropout_is_seeded_and_identity_at_zero():
    x = torch.randn(2, 12, 128)
    src = torch.randn(2, 3, 128)
    net = _layer_stack(0.0)
    net.train()
    train0 = net(x, cross_attention_src=src, dropout_seed=5)
    net.eval()
    assert torch.equal(train0, net(x, cross_attention_src=src))
    net = _layer_stack(0.2)
    net.train()
    a = net(x, cross_attention_src=src, dropout_seed=5)
    b = net(x, cross_attention_src=src, dropout_seed=5)
    c = net(x, cross_attention_src=src, dropout_seed=6)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    net.eval()
    assert not torch.allclose(a, net(x, cross_attention_src=src))


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_torch_checkpointing_gives_the_same_gradients(monkeypatch, p):
    """Per-layer recompute replays the same dropout masks, so 'torch' and
    'none' give equal outputs and gradients. Without attention dropout the
    self-attention takes the kernel's route, twice per layer under 'torch'
    (forward, then the recompute in backward)."""
    calls = _count_flash(monkeypatch)
    x = torch.randn(2, 12, 128)
    src = torch.randn(2, 3, 128)
    grads, outs, routed = [], [], []
    for mode in ("none", "torch"):
        net = _layer_stack(p, mode)
        net.train()
        calls.clear()
        out = net(x, cross_attention_src=src, dropout_seed=11)
        out.square().sum().backward()
        routed.append(len(calls))
        outs.append(out.detach())
        grads.append([q.grad for q in net.parameters()])
    assert routed == ([2, 4] if p == 0.0 else [0, 0])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["dots", "dots_nb"])
def test_selective_checkpointing_is_not_ported(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _layer_stack(0.0, mode)
