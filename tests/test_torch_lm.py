"""The port's LM vs the JAX package at the `xsmall` scale (dim 64, 2 layers,
cross-attention on a lookup-table text conditioner) in f32 on the CPU:
logits, greedy generation over f32 and int8 caches, top-k and top-p support,
and the state-dict keys checked against `audiocraft_tpu/utils/torch_port.py`.

Tolerance: logits atol 1e-4 / rtol 1e-4 (f32; sums in another order).
Greedy tokens must be equal; where they differ, the test accepts the
difference only at a step whose top-2 logit margin is under 1e-4, and
reports it as a warning."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.models.presets import musicgen_lm as jax_musicgen_lm
from audiocraft_tpu.modules.conditioners import \
    ConditioningAttributes as JaxAttrs
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models.lm import GenParams
from audiocraft_tpu_torch.models.presets import musicgen_lm
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.utils import jax_weights
from audiocraft_tpu_torch.utils.utils import sample_tokens

CARD = 64
TEXTS = ["warm analog synth arpeggio", "fast drum and bass"]
MARGIN_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jax_musicgen_lm("xsmall", card=CARD)
    params = jlm.init_lm_params(jmodel, jax.random.PRNGKey(0))
    port = musicgen_lm("xsmall", card=CARD).eval()
    jax_weights.load_lm(port, jax.tree.map(np.asarray, params))
    return jmodel, params, port


def _attrs(cls):
    return [cls(text={"description": t}) for t in TEXTS]


def _port_cfg_conditions(port):
    return port.prepare_cfg_conditions(_attrs(ConditioningAttributes))


def test_logits_match_jax(models):
    jmodel, params, port = models
    seq = np.random.RandomState(1).randint(0, CARD + 1, (2, 4, 10))
    tokenized = jlm.tokenize_conditions(jmodel, _attrs(JaxAttrs))
    ct = jmodel.apply(params, tokenized, method=jlm.LMModel.compute_conditions)
    expected, _ = jmodel.apply(params, jnp.asarray(seq), ct)
    tct = port.compute_conditions(
        port.condition_provider.tokenize(_attrs(ConditioningAttributes)))
    with torch.no_grad():
        got = port(torch.from_numpy(seq), tct)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-4,
                               rtol=1e-4)


def _teacher_forced(port, codes):
    """The CFG-combined logits the port predicts for each pattern step of
    `codes` [B, K, T]: (sequence [B, K, S], mask [K, S], logits where
    logits[:, :, s] predicts step s + 1)."""
    B, K, T = codes.shape
    pattern = port.pattern_provider.get_pattern(T)
    seq, _, mask = pattern.build_pattern_sequence(codes, port.special_token_id)
    with torch.no_grad():
        logits = port(torch.cat([seq, seq]), _port_cfg_conditions(port))
    cond, uncond = logits[:B], logits[B:]
    return seq, mask, uncond + (cond - uncond) * port.cfg_coef


def _assert_same_greedy_tokens(port, got, expected):
    got, expected = got.numpy(), np.asarray(expected)
    if (got == expected).all():
        return
    # first timestep where they differ: equal only if the port's own top-2
    # margin there is below the tolerance (a near-tie, not a bug)
    t = int(np.argwhere((got != expected).any(axis=(0, 1)))[0, 0])
    _, mask, logits = _teacher_forced(port, torch.from_numpy(expected))
    pattern = port.pattern_provider.get_pattern(got.shape[-1])
    margins = []
    for s, coord in pattern.get_sequence_coords_with_timestep(t):
        top2 = torch.topk(logits[:, coord.q, s - 1], 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    assert min(margins) < MARGIN_TOL, \
        f"greedy tokens differ at timestep {t}, top-2 margins {margins}"
    warnings.warn(f"greedy tokens differ at timestep {t} where the top-2 "
                  f"logit margin {min(margins):.2e} < {MARGIN_TOL}")


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_greedy_generation_matches_jax(models, cache_dtype):
    jmodel, params, port = models
    expected = jlm.generate(jmodel, params, jax.random.PRNGKey(0),
                            conditions=_attrs(JaxAttrs), max_gen_len=12,
                            gen=jlm.GenParams(use_sampling=False),
                            cache_dtype=getattr(jnp, cache_dtype))
    got = port.generate(conditions=_attrs(ConditioningAttributes),
                        max_gen_len=12, gen=GenParams(use_sampling=False),
                        cache_dtype=getattr(torch, cache_dtype), device="cpu")
    assert got.shape == (2, 4, 12)
    _assert_same_greedy_tokens(port, got, expected)


def test_greedy_generation_is_the_teacher_forced_argmax(models):
    """Step-by-step decode through the cache and the decode-attention path
    equals a single causal forward over the generated sequence."""
    _, _, port = models
    codes = port.generate(conditions=_attrs(ConditioningAttributes),
                          max_gen_len=10, gen=GenParams(use_sampling=False),
                          device="cpu")
    seq, mask, logits = _teacher_forced(port, codes)
    pred = logits.argmax(-1)
    for s in range(1, seq.shape[-1]):
        valid = torch.from_numpy(mask[:, s])
        assert torch.equal(seq[:, valid, s], pred[:, valid, s - 1]), s


def test_top_k_samples_lie_in_the_top_k_set(models):
    _, _, port = models
    k = 5
    g = torch.Generator().manual_seed(3)
    codes = port.generate(conditions=_attrs(ConditioningAttributes),
                          max_gen_len=16, gen=GenParams(top_k=k),
                          generator=g, device="cpu")
    assert ((codes >= 0) & (codes < CARD)).all()
    seq, mask, logits = _teacher_forced(port, codes)
    top = torch.topk(logits, k, dim=-1).indices  # [B, K, S, k]
    for s in range(1, seq.shape[-1]):
        for q in np.flatnonzero(mask[:, s]):
            tok = seq[:, q, s]
            assert (top[:, q, s - 1] == tok[:, None]).any(-1).all(), (s, q)
    # sampling, not greedy: some step departs from the argmax
    assert not torch.equal(seq[:, :, 1:], logits.argmax(-1)[:, :, :-1])


def test_state_dict_keys_convert_back_to_jax_params(models):
    """port state_dict -> torch_port.convert_lm_state (upstream audiocraft
    keys) == the JAX params the port was loaded from."""
    jmodel, params, port = models
    src = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_port.convert_lm_state(src, n_q=4, num_layers=2,
                                       cross_attention=True, bias_proj=False,
                                       norm_first=True)["params"]
    cond, _ = torch_port.convert_lm_conditioners(src, jmodel)
    back.update(cond)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params["params"]))


@pytest.mark.parametrize("mode", ["greedy", "top_k", "top_p"])
def test_sample_tokens_support(mode):
    """Greedy is the argmax; top-k and top-p samples lie in the top-k set and
    in the nucleus (the smallest prefix of the sorted probabilities whose
    mass before each kept token is at most p)."""
    logits = torch.from_numpy(
        np.random.RandomState(7).randn(64, 4, 50).astype(np.float32) * 3)
    kw = {"greedy": dict(use_sampling=False), "top_k": dict(top_k=5),
          "top_p": dict(top_p=0.6)}[mode]
    g = torch.Generator().manual_seed(0)
    tok = sample_tokens(logits, generator=g, **kw)
    assert tok.shape == (64, 4, 1)
    if mode == "greedy":
        assert torch.equal(tok, logits.argmax(-1, keepdim=True))
        return
    probs = torch.softmax(logits, -1)
    if mode == "top_k":
        allowed = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            -1, probs.topk(5, -1).indices, True)
    else:
        sorted_p, idx = probs.sort(-1, descending=True)
        keep = (sorted_p.cumsum(-1) - sorted_p) <= 0.6
        allowed = torch.zeros_like(keep).scatter_(-1, idx, keep)
    assert allowed.gather(-1, tok).all()
    assert not torch.equal(tok, logits.argmax(-1, keepdim=True))
