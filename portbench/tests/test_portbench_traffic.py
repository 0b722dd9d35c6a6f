"""The traffic made from a seed is the same run to run, differs across
seeds, and gives every seed the same sizes in another order."""
import json
from collections import Counter

import pytest
import torch

from harness import manifest, traffic

MIXES = sorted(p.stem for p in (manifest.BENCH_DIR / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((manifest.BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _texts(mix, seed, n=8):
    t = traffic.make(mix, seed)
    if isinstance(t, traffic.LMTraining):
        return [t.texts()]
    return [t.request(i).texts for i in [*traffic.TextToMusic.WARMUP, *range(n)]]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = _mix(name)
    assert _texts(mix, 2 ** 33 + 17) == _texts(mix, 2 ** 33 + 17)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ(name):
    mix = _mix(name)
    assert _texts(mix, 5) != _texts(mix, 6)


@pytest.mark.parametrize("name", MIXES)
def test_same_sizes_every_seed(name):
    mix = _mix(name)
    cycle = len(mix["word_counts"])
    per = mix.get("texts_per_request", mix.get("batch"))
    n = cycle // per if cycle % per == 0 and cycle >= per else 1

    def counts(seed):
        texts = [t for req in _texts(mix, seed, n)[-n:] for t in req]
        return Counter(len(t.split()) for t in texts)
    assert counts(1) == counts(2 ** 40 + 3)


def test_greedy_share_and_checked_rows():
    mix = _mix("gen96")
    t = traffic.make(mix, 9)
    assert [t.greedy(i) for i in range(8)] == [False, False, False, True] * 2
    assert [r.greedy for r in map(t.request, traffic.TextToMusic.WARMUP)] == [False, True]
    rows = t.rows_to_check(3)
    assert rows == traffic.make(mix, 9).rows_to_check(3)
    assert len(rows) == mix["rows_checked"] and len(set(rows)) == len(rows)
    assert t.requests_to_check([3, 7, 11]) == traffic.make(mix, 9).requests_to_check([3, 7, 11])


@pytest.mark.parametrize("name", [m for m in MIXES
                                  if _mix(m)["kind"] == "text_to_music"])
def test_checked_requests_take_both_kinds(name):
    """The check reads greedy and sampled requests, as many of each as the
    mix asks, drawn from the seed."""
    mix = _mix(name)
    t = traffic.make(mix, 2 ** 36 + 1)
    chosen = t.requests_to_check(range(40))
    assert chosen == traffic.make(mix, 2 ** 36 + 1).requests_to_check(range(40))
    assert sum(t.greedy(i) for i in chosen) == mix["requests_checked"]
    assert sum(not t.greedy(i) for i in chosen) == mix["sampled_checked"]


def test_training_codes():
    t = traffic.make(_mix("train16x30s"), 2 ** 35)
    a = t.codes(torch, 4, 2048, 30, "cpu")
    assert a.shape == (16, 4, 30) and int(a.max()) < 2048
    assert torch.equal(a, traffic.make(_mix("train16x30s"), 2 ** 35).codes(
        torch, 4, 2048, 30, "cpu"))
    assert not torch.equal(a, traffic.make(_mix("train16x30s"), 7).codes(
        torch, 4, 2048, 30, "cpu"))
