"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (CPU, debug sizes, program and
limits in float32), the rest of the run is driven as on the card."""
import pytest
import torch

import run

SEED = 2 ** 34 + 1


def _run(cell):
    return run.run_cell(cell, SEED, 0, False, torch.device("cpu"), torch,
                        count=4)


def _altered_token(monkeypatch):
    """The LM's sampler returns a wrong code once, at its fifth call."""
    from audiocraft_tpu_torch.models import lm as lm_module
    plain, calls = lm_module.sample_tokens, []

    def sample(logits, **kw):
        out = plain(logits, **kw)
        calls.append(1)
        if len(calls) % 5 == 0:
            out = out.clone()
            out[0, 0] = (out[0, 0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(lm_module, "sample_tokens", sample)


def _unchanged_cache(monkeypatch):
    """A decode step whose KV cache comes back unchanged."""
    from audiocraft_tpu_torch.modules.transformer import KVCache

    def write(self, k, v, positions):
        self.index.add_(k.shape[1])
    monkeypatch.setattr(KVCache, "write", write)


def _altered_audio(monkeypatch):
    """The codec's answer altered where it is produced."""
    from audiocraft_tpu_torch.models.encodec import EncodecModel
    plain = EncodecModel.decode

    def decode(self, *args, **kwargs):
        out = plain(self, *args, **kwargs)
        return torch.cat([out[..., :out.shape[-1] // 2],
                          torch.zeros_like(out[..., out.shape[-1] // 2:])], -1)
    monkeypatch.setattr(EncodecModel, "decode", decode)


def _sampling_without_top_k(monkeypatch):
    """The sampling branch draws from every code, not from the top k (the
    greedy requests are untouched)."""
    from audiocraft_tpu_torch.models import lm as lm_module
    plain = lm_module.sample_tokens

    def sample(logits, **kw):
        if kw.get("use_sampling"):
            kw["top_k"] = 0
        return plain(logits, **kw)
    monkeypatch.setattr(lm_module, "sample_tokens", sample)


@pytest.mark.parametrize("fault", [_altered_token, _unchanged_cache,
                                   _altered_audio, _sampling_without_top_k])
def test_generate_faults(debug_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(debug_cell("gen"))
    assert not out["correct"], out["checks"]


def _unchanged_state(monkeypatch):
    """An optimizer step that leaves the weights and its state as they
    were."""
    from audiocraft_tpu_torch.solvers import builders
    monkeypatch.setattr(builders.ClippedOptimizer, "step",
                        lambda self: torch.zeros(()))


def _half_batch(monkeypatch):
    """Half the batch left out of the loss, the mean over the rest."""
    from audiocraft_tpu_torch.solvers import musicgen
    plain = musicgen.compute_cross_entropy

    def ce(logits, targets, mask, mesh=None):
        half = targets.shape[0] // 2
        return plain(logits[:half], targets[:half], mask[:half], mesh)
    monkeypatch.setattr(musicgen, "compute_cross_entropy", ce)


def _altered_target(monkeypatch):
    """One target code altered where the loss reads it."""
    from audiocraft_tpu_torch.solvers import musicgen
    plain = musicgen.compute_cross_entropy

    def ce(logits, targets, mask, mesh=None):
        targets = targets.clone()
        targets[0, 0, 0] = (targets[0, 0, 0] + 1) % logits.shape[-1]
        return plain(logits, targets, mask, mesh)
    monkeypatch.setattr(musicgen, "compute_cross_entropy", ce)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_target])
def test_training_faults(debug_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(debug_cell("train"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_unknown_tokenizer_fails_setup(debug_cell, monkeypatch, kind):
    """A conditioner that tokenizes without the hash (every word one
    unknown id, as a T5 tokenizer without a vocabulary does) stops the run
    at set-up, before any result."""
    import numpy as np
    from audiocraft_tpu_torch.modules.conditioners import T5Conditioner

    def tokenize(self, x):
        n = max(len((t or "").split()) for t in x)
        return (np.full((len(x), n), 2, np.int32),
                np.ones((len(x), n), np.int32))
    monkeypatch.setattr(T5Conditioner, "tokenize", tokenize)
    with pytest.raises(RuntimeError, match="hash"):
        _run(debug_cell(kind))
