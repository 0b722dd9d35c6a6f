"""The operation and byte counts of the yardstick against hand counts."""
import pytest

from harness import counts


@pytest.mark.parametrize("kind,bytes_,ops", [
    # n = B * length * H = 30; K and V: 2 n D elements; q in, out: 2 B H D
    ("bfloat16", 2 * 30 * 4 * 2 + 2 * 2 * 3 * 4 * 2, 4 * 30 * 4),
    ("int8", 2 * 30 * 4 * 1 + 2 * 2 * 3 * 4 * 2 + 2 * 30 * 2, 4 * 30 * 4 + 60),
])
def test_k1(kind, bytes_, ops):
    assert counts.k1_bytes_and_ops(2, 3, 4, 5, kind, 2) == (bytes_, ops)


def test_k1_bound_takes_the_longer():
    b, ops = counts.k1_bytes_and_ops(64, 16, 64, 500, "bfloat16", 2)
    assert counts.k1_bound_s(64, 16, 64, 500) == max(
        b / 3.35e12, ops / 67e12)


@pytest.mark.parametrize("B,T,H,D", [(1, 4, 2, 8), (16, 1501, 16, 64)])
def test_flash(B, T, H, D):
    n = B * T * H * D
    pairs = T * (T + 1) // 2
    fwd_ops = 2 * 2 * B * H * pairs * D  # q.k and p.v over causal pairs
    assert counts.flash_bytes_and_ops(B, T, H, D, False) == (
        4 * n * 2 + 4 * B * H * T, fwd_ops)
    assert counts.flash_bytes_and_ops(B, T, H, D, True) == (
        8 * n * 2 + 4 * B * H * T, 2.5 * fwd_ops)


def test_train_step_flops():
    # 6 N per token and 12 L T^2 d per sample, by hand at two sizes
    assert counts.train_step_flops(10, 2, 3, 4, 5) == 6 * 10 * 6 + 12 * 4 * 9 * 5 * 2
    assert counts.train_step_flops(420_000_000, 16, 1501, 24, 1024) == (
        6 * 420e6 * 16 * 1501 + 12 * 24 * 1501 ** 2 * 1024 * 16)


def test_generate_flops_by_hand():
    lm = {"dim": 4, "num_layers": 1, "hidden_scale": 2, "n_q": 2, "card": 3}
    t5 = {"d_model": 2, "num_heads": 1, "d_kv": 2, "d_ff": 3, "num_layers": 1}
    # per forward: dense weights (4 + 2 + 2 * 2) * 16 + 2 * 3 * 4 = 184
    dense = 2 * 184 * 2                      # 2 forwards
    attention = 4 * 1 * 4 * ((1 + 2) + 2 * 5)  # self lengths 1, 2; 5 keys
    cross_kv = 2 * 1 * 2 * 16 * 5
    t5_one = (2 * (4 * 2 * 2 + 2 * 2 * 3) * 5 + 2 * 2 * 25 * 2
              + 2 * 2 * 4 * 5)
    assert counts.generate_flops(lm, t5, 3, 2, 5) == 3 * (
        dense + attention + cross_kv + t5_one)
