"""The port's causal flash attention (K2) on the CPU: its plain version
against the JAX package's off-TPU route (`dot_product_attention` with
`make_causal_bias`, which `tests/ops/test_flash_attention.py` holds the Pallas
kernel against), its explicit backward, `opcheck` of the two
`torch.library` ops, the eligibility rule, the transformer's routing,
dropout, `checkpointing='torch'`, and the selective policies 'dots' and
'dots_nb' against the JAX package's.

Tolerance: f32, output and dQ/dK/dV atol 1e-5 (the same sums in another
order). The CUDA kernels themselves are held against the plain version on the
card (`tests/test_torch_gpu.py`, `chip_smoke.py`)."""
import collections
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audiocraft_tpu.ops import attention as jattn
from audiocraft_tpu_torch.modules import transformer as ttr
from audiocraft_tpu_torch.ops.attention import (dot_product_attention, dropout,
                                                flash_causal_eligible)
from audiocraft_tpu_torch.ops.flash_causal_attention import (
    flash_causal_attention, flash_causal_attention_reference)

# the module (the package re-exports the function under its name)
fca_module = sys.modules["audiocraft_tpu_torch.ops.flash_causal_attention"]


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
                       flash_causal_attention_reference(q, q, q)[0])
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


def _jax_stack_grads(mode, x, src, params):
    """The JAX package's transformer of `_layer_stack`'s shape under
    `checkpointing=mode`: output and the gradients of sum(y^2)."""
    from audiocraft_tpu.modules.transformer import StreamingTransformer
    tr = StreamingTransformer(d_model=128, num_heads=2, num_layers=2,
                              dim_feedforward=256, causal=True,
                              cross_attention=True, checkpointing=mode)

    def loss(p):
        y, _ = tr.apply(p, jnp.asarray(x), cross_attention_src=jnp.asarray(src))
        return jnp.sum(y ** 2), y
    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), grads


@pytest.mark.parametrize("mode", ["dots", "dots_nb"])
def test_selective_checkpointing_matches_jax(mode):
    """'dots' and 'dots_nb' give the JAX package's outputs and every
    gradient under the same policy (f32; outputs atol 1e-5, each gradient
    within 1e-5 of its largest entry: sums of 24 rows of order-1 terms in
    another order)."""
    from audiocraft_tpu.modules.transformer import StreamingTransformer
    from audiocraft_tpu_torch.utils import jax_weights
    rs = np.random.RandomState(8)
    x = rs.randn(2, 12, 128).astype(np.float32)
    src = rs.randn(2, 3, 128).astype(np.float32)
    params = StreamingTransformer(
        d_model=128, num_heads=2, num_layers=2, dim_feedforward=256,
        causal=True, cross_attention=True).init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        cross_attention_src=jnp.asarray(src))
    want_y, want_grads = _jax_stack_grads(mode, x, src, params)
    net = _layer_stack(0.0, mode)
    jax_weights.load_transformer(net, jax.tree.map(np.asarray, params))
    net.train()
    y = net(torch.from_numpy(x), cross_attention_src=torch.from_numpy(src))
    y.square().sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5, rtol=0)
    expected = jax_weights.transformer_state(
        jax.tree.map(np.asarray, want_grads)["params"], 2)
    named = dict(net.named_parameters())
    assert set(named) == set(expected)
    for name, p in named.items():
        want = expected[name]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(mode: str, p: float = 0.0) -> collections.Counter:
    """The ops the backward of a training forward dispatches, with the
    recompute of the checkpointed layers."""
    x = torch.randn(2, 12, 128, generator=torch.Generator().manual_seed(2))
    src = torch.randn(2, 3, 128, generator=torch.Generator().manual_seed(3))
    net = _layer_stack(p, mode)
    net.train()
    out = net(x, cross_attention_src=src, dropout_seed=5)
    with _OpCounter() as counter:
        out.square().sum().backward()
    return counter.counts


@pytest.mark.parametrize("mode", ["dots", "dots_nb"])
def test_selective_checkpointing_recomputes_no_product(mode):
    """A dispatch counter over the backward: under both policies it runs
    the unbatched products ('mm', 'addmm') and the flash forward exactly as
    often as without checkpointing (none is recomputed), while 'torch'
    recomputes them; under 'dots_nb' the batched products of the
    cross-attention (two per layer) are recomputed, under 'dots' none."""
    aten = torch.ops.aten
    fwd = torch.ops.audiocraft_tpu_torch.flash_causal_fwd.default
    none, ours, full = (_backward_ops(m) for m in ("none", mode, "torch"))
    for op in (aten.mm.default, aten.addmm.default, fwd):
        assert ours[op] == none[op], op
    assert none[fwd] == 0 and full[fwd] == 2 and full[aten.addmm.default] > 0
    extra_bmm = ours[aten.bmm.default] - none[aten.bmm.default]
    assert extra_bmm == {"dots": 0, "dots_nb": 4}[mode]


@pytest.mark.parametrize("mode", ["dots", "dots_nb"])
def test_selective_checkpointing_replays_dropout(mode):
    """With residual dropout the recompute draws the same masks: outputs
    and gradients equal 'none''s."""
    x = torch.randn(2, 12, 128)
    src = torch.randn(2, 3, 128)
    results = []
    for m in ("none", mode):
        net = _layer_stack(0.2, m)
        net.train()
        out = net(x, cross_attention_src=src, dropout_seed=11)
        out.square().sum().backward()
        results.append((out.detach(), [q.grad for q in net.parameters()]))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("inputs", ["separate", "fused_qkv_chunks"])
def test_the_forward_op_passes_opcheck(inputs):
    """`torch.library.opcheck` on the CPU: schema, fake tensor (shapes,
    dtypes and contiguous strides), autograd registration."""
    g = torch.Generator().manual_seed(4)
    if inputs == "separate":
        args = tuple(torch.randn(2, 37, 2, 64, generator=g).requires_grad_()
                     for _ in range(3))
    else:
        x = torch.randn(2, 37, 3 * 128, generator=g).requires_grad_()
        args = tuple(t.reshape(2, 37, 2, 64) for t in x.chunk(3, dim=-1))
    torch.library.opcheck(fca_module.flash_causal_fwd, args)


def test_the_backward_op_passes_opcheck():
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 20, 2, 128, generator=g) for _ in range(3))
    out, lse = fca_module.flash_causal_fwd(q, k, v)
    torch.library.opcheck(fca_module.flash_causal_bwd,
                          (q, k, v, out, lse, torch.randn_like(out)))


@pytest.mark.parametrize("T", [1, 33, 130])
def test_plain_backward_equals_autograd_and_jax(T):
    """The explicit backward (delta, dS, dQ, dK, dV from the saved lse)
    equals autograd of the plain forward and the JAX package's VJP."""
    rs = np.random.RandomState(T)
    q, k, v, do = (rs.randn(2, T, 2, 64).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(_jax_causal, q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fca_module.flash_causal_attention_reference(tq, tk, tv)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    plain = fca_module.flash_causal_attention_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse.detach(),
        torch.from_numpy(do))
    for got, a, w in zip(plain, auto, want):
        np.testing.assert_allclose(got.numpy(), a.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
