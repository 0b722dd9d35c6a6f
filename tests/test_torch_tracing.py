"""`utils.tracing` on the CPU: spans off cost a flag check and record
nothing; on (after `enable()`, or under `torch.profiler`) a tiny
`MusicGen.generate` and a tiny `MusicGenSolver.run_step` give the trees of
spans that the program places, with shared root ids, parents and self
times, on the profiler's clock; spans nest per thread. The card's side
(CUDA events, the decode graph's spans) is in `test_torch_gpu.py`."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiocraft_tpu_torch.data import AudioInfo, AudioMeta, MusicInfo
from audiocraft_tpu_torch.models import MusicGen
from audiocraft_tpu_torch.solvers import musicgen as tmg
from audiocraft_tpu_torch.utils import tracing

TEXTS = ["warm analog synth arpeggio", "fast drum and bass"]
GENERATE = ["lm.conditions", "lm.prefill", "lm.decode", "codec.decode"]
STEP = ["solver.batch", "solver.forward", "solver.backward",
        "solver.optimizer"]


@pytest.fixture
def spans():
    """Tracing off and no roots kept, before and after the test."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def musicgen():
    mg = MusicGen.get_pretrained("debug", device="cpu")
    mg.set_generation_params(duration=0.5, use_sampling=False)
    return mg


def _batch(B=2, T=12800, sr=32000):
    rs = np.random.RandomState(0)
    wav = (0.1 * rs.randn(B, 1, T)).astype(np.float32)
    infos = [MusicInfo(**AudioInfo(AudioMeta("x.wav", T / sr, sr), 0.0, T, T,
                                   sr, 1).to_dict(), description=TEXTS[i % 2])
             for i in range(B)]
    return wav, infos


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    cfg = {"seed": 0, "sample_rate": 32000,
           "compression_model_checkpoint": "debug",
           "folder": str(tmp_path_factory.mktemp("tracing")),
           "optim": {"epochs": 1, "updates_per_epoch": 1,
                     "optimizer": "adamw", "lr": 1e-3,
                     "adam": {"betas": [0.9, 0.95], "weight_decay": 0.1}}}
    return tmg.MusicGenSolver(cfg, device="cpu")


def _walk(span):
    yield span
    for child in span.children:
        yield from _walk(child)


def _check_tree(root, children):
    assert root.parent_id is None and root.root_id == root.id
    assert [c.name for c in root.children] == children
    for s in _walk(root):
        assert s.root_id == root.id
        assert s.start_ns <= s.end_ns
        assert 0.0 <= s.self_ms <= s.host_ms + 1e-9
        assert s.device_ms is None and s.counters == {}  # the CPU
        for c in s.children:
            assert c.parent_id == s.id
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
    covered = sum(c.host_ms for c in root.children)
    assert root.self_ms == pytest.approx(root.host_ms - covered, abs=1e-3)


def test_spans_off_record_nothing_beyond_a_flag_check(spans, monkeypatch,
                                                      musicgen, solver):
    def fail(*args, **kwargs):
        raise AssertionError("called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.cuda, "memory_stats", fail)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", fail)
    monkeypatch.setattr(torch.cuda, "Event", fail)
    with monkeypatch.context() as m:  # as though CUDA were in use
        m.setattr(torch.cuda, "is_initialized", lambda: True)
        first = tracing.span("a", device=True, rows=2)
        with first as s, tracing.span("b") as inner:
            s.set_host(0, 1)
            inner.set_events(None, None)
        assert first is tracing.span("c") and first is s is inner
    musicgen.generate(TEXTS[:1])
    solver.run_step(0, _batch(), {})
    assert tracing.roots() == []


def test_generate_gives_its_tree(spans, musicgen):
    tracing.enable()
    musicgen.generate(TEXTS)
    tracing.disable()
    musicgen.generate(TEXTS[:1])  # off again: not kept
    (root,) = tracing.roots()
    assert root.name == "generate" and root.attrs == {"rows": 2, "frames": 12}
    _check_tree(root, GENERATE)
    assert all(not c.children for c in root.children)  # the CPU decode loop


def test_run_step_gives_its_tree_in_each_stage(spans, solver):
    tracing.enable()
    solver.run_step(0, _batch(), {})
    solver.current_stage = "valid"
    try:
        solver.run_step(1, _batch(), {})
    finally:
        solver.current_stage = "train"
    train, valid = tracing.roots()
    assert train.name == valid.name == "solver.step"
    assert train.attrs == {"stage": "train", "idx": 0}
    assert valid.attrs == {"stage": "valid", "idx": 1}
    _check_tree(train, STEP)
    _check_tree(valid, ["solver.batch"])
    assert train.id != valid.id


def test_spans_are_on_under_the_profiler_on_its_clock(spans, musicgen):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        musicgen.generate(TEXTS[:1])
    (root,) = tracing.roots()
    _check_tree(root, GENERATE)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for s in _walk(root):
        (event,) = events[s.name]
        assert abs(s.start_ns - event.start_ns()) < 2_000_000, s.name
        assert abs(s.end_ns - event.end_ns()) < 2_000_000, s.name
    musicgen.generate(TEXTS[:1])  # the profiler stopped: spans off
    assert len(tracing.roots()) == 1


def test_spans_nest_per_thread(spans):
    tracing.enable()
    barrier = threading.Barrier(4)
    errors = []

    def work(k):
        try:
            with tracing.span(f"outer{k}", thread=k):
                barrier.wait(timeout=10)
                with tracing.span(f"inner{k}"):
                    barrier.wait(timeout=10)
                    with tracing.span(f"leaf{k}"):
                        pass
                barrier.wait(timeout=10)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    roots = tracing.roots()
    assert sorted(r.name for r in roots) == [f"outer{k}" for k in range(4)]
    for r in roots:
        k = r.attrs["thread"]
        (inner,) = r.children
        (leaf,) = inner.children
        assert (inner.name, leaf.name) == (f"inner{k}", f"leaf{k}")
        assert leaf.parent_id == inner.id and inner.parent_id == r.id
        assert leaf.root_id == inner.root_id == r.id
    assert len({r.id for r in roots}) == 4


def test_set_host_and_the_bounded_deque(spans):
    tracing.enable()
    with tracing.span("outer") as outer:
        with tracing.span("timed") as timed:
            pass
        timed.set_host(outer.start_ns, outer.start_ns + 3_000_000)
    assert timed.host_ms == 3.0 and timed.device_ms is None
    for k in range(tracing.MAX_ROOTS + 5):
        with tracing.span("r", k=k):
            pass
    kept = tracing.roots()
    assert len(kept) == tracing.MAX_ROOTS
    assert [r.attrs["k"] for r in kept[:2]] == [5, 6]  # oldest first
