"""Delay-pattern tables and build/revert of the port vs the JAX package:
integer gathers, so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.modules import patterns as jpatterns
from audiocraft_tpu.modules.patterns import \
    DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.models.builders import get_codebooks_pattern_provider
from audiocraft_tpu_torch.modules.patterns import DelayedPatternProvider

SETTINGS = [  # n_q, delays, timesteps
    (4, None, 500),
    (4, None, 13),
    (2, [0, 3], 9),
    (8, None, 25),
]


@pytest.mark.parametrize("n_q,delays,T", SETTINGS)
def test_build_and_revert_match_jax(n_q, delays, T):
    jpat = JaxDelayed(n_q, delays).get_pattern(T)
    pat = DelayedPatternProvider(n_q, delays).get_pattern(T)
    assert pat.layout == jpat.layout
    assert pat.num_sequence_steps == jpat.num_sequence_steps
    assert (pat.get_first_step_with_timesteps(0)
            == jpat.get_first_step_with_timesteps(0))
    codes = np.random.RandomState(T).randint(0, 100, (2, n_q, T)).astype(np.int32)
    jseq, _, jmask = jpat.build_pattern_sequence(jnp.asarray(codes), 100)
    seq, _, mask = pat.build_pattern_sequence(torch.from_numpy(codes), 100)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(mask, jmask)
    jrev, _, _ = jpat.revert_pattern_sequence(jseq, -1)
    rev, _, rmask = pat.revert_pattern_sequence(seq, -1)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(rev.numpy(), codes)  # build then revert
    assert rmask.all()


def test_revert_logits_match_jax():
    jpat = JaxDelayed(4).get_pattern(11)
    pat = DelayedPatternProvider(4).get_pattern(11)
    logits = np.random.RandomState(0).randn(2, 5, 4, 14).astype(np.float32)
    jout, _, jmask = jpat.revert_pattern_logits(jnp.asarray(logits), 0.0)
    out, _, mask = pat.revert_pattern_logits(torch.from_numpy(logits), 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(mask, jmask)


def test_musicgen_10s_pattern_shape():
    """500 frames: 503 pattern steps after the initial special step, the
    first frame at step 1; a generation makes one forward per step."""
    pat = DelayedPatternProvider(4).get_pattern(500)
    assert pat.num_sequence_steps == 503
    assert len(pat.layout) == 504
    assert pat.get_first_step_with_timesteps(0) == 1


PROVIDERS = [  # modeling, kwargs
    ("unroll", dict()),
    ("unroll", dict(flattening=[0, 1, 1, 2], delays=[0, 1, 1, 2])),
    ("unroll", dict(flattening=[0, 0, 2, 3], delays=[0, 0, 1, 3])),
    ("coarse_first", dict()),
    ("coarse_first", dict(delays=[0, 1, 2])),
    ("musiclm", dict()),
    ("musiclm", dict(group_by=4)),
]
JAX_PROVIDERS = {"unroll": jpatterns.UnrolledPatternProvider,
                 "coarse_first": jpatterns.CoarseFirstPattern,
                 "musiclm": jpatterns.MusicLMPattern}


@pytest.mark.parametrize("modeling,kwargs", PROVIDERS)
@pytest.mark.parametrize("T", [1, 7])
def test_other_providers_build_and_revert_as_jax(modeling, kwargs, T):
    """The unroll, coarse_first and musiclm providers, routed by the
    builder's `codebooks_pattern` config: the same layout, sequence and
    masks as the JAX providers, and build then revert gives the codes."""
    provider = get_codebooks_pattern_provider(
        4, {"modeling": modeling, modeling: kwargs})
    pat = provider.get_pattern(T)
    jpat = JAX_PROVIDERS[modeling](4, **kwargs).get_pattern(T)
    assert pat.layout == jpat.layout
    codes = np.random.RandomState(T).randint(0, 100, (2, 4, T)).astype(np.int32)
    jseq, _, jmask = jpat.build_pattern_sequence(jnp.asarray(codes), 100)
    seq, _, mask = pat.build_pattern_sequence(torch.from_numpy(codes), 100)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(mask, jmask)
    jrev, _, jrmask = jpat.revert_pattern_sequence(jseq, -1)
    rev, _, rmask = pat.revert_pattern_sequence(seq, -1)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(rmask, jrmask)
    np.testing.assert_array_equal(rev.numpy(), codes)
