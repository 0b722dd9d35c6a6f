"""T5 encoder, tokenizers and the text conditioners of the port vs the JAX
package, at a tiny width (2 layers, d_model 64) in f32.

Tolerance for the encoder: atol 1e-4 / rtol 1e-4 (f32, 2 layers of f32
attention and RMS norms; sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import t5 as jt5
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import builders as tbuilders
from audiocraft_tpu_torch.modules import conditioners as tcond
from audiocraft_tpu_torch.modules import t5 as tt5
from audiocraft_tpu_torch.utils import jax_weights

TEXTS = ["90s Rock song, with loud guitars!", "calm piano", None, "",
         "Lo-fi; hip hop: beats?"]


def _cfg(gated):
    return dict(vocab_size=100, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                num_heads=4, gated_ffn=gated)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_encoder_matches_jax(gated):
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 100, (3, 9)).astype(np.int32)
    mask = (np.arange(9)[None] < np.array([[9], [4], [1]])).astype(np.int32)
    enc = jt5.T5Encoder(jt5.T5EncoderConfig(**_cfg(gated)))
    params = enc.init(jax.random.PRNGKey(0), tokens, mask)
    expected = enc.apply(params, tokens, mask)
    port = tt5.T5Encoder(tt5.T5EncoderConfig(**_cfg(gated)))
    jax_weights.load_t5(port, jax.tree.map(np.asarray, params))
    got = port(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected),
                               atol=1e-4, rtol=1e-4)
    # the port's keys are Hugging Face's: the JAX package's converter reads
    # them back into exactly the parameters the port was loaded from
    src = {k: v.numpy() for k, v in port.state_dict().items()}
    jax.tree.map(np.testing.assert_array_equal,
                 torch_port.convert_t5_encoder(src, num_layers=2),
                 jax.tree.map(np.asarray, params)["params"])


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 300)[None, :]
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel),
                                  jt5.relative_position_bucket(rel))


@pytest.mark.parametrize("n_bins", [32128, 128])
def test_whitespace_tokenizer_ids_match_jax(n_bins):
    jtok, jmask = jcond.WhiteSpaceTokenizer(n_bins)(TEXTS)
    tok, mask = tcond.WhiteSpaceTokenizer(n_bins)(TEXTS)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("n_bins", [32128, 128])
def test_noop_tokenizer_ids_match_jax(n_bins):
    """One hashed token per whole text; a missing text is the pad token
    with mask 0."""
    texts = TEXTS + ["Jazz."]
    jtok, jmask = jcond.NoopTokenizer(n_bins)(texts)
    tok, mask = tcond.NoopTokenizer(n_bins)(texts)
    assert tok.shape == (len(texts), 1)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(mask, jmask)


def test_lut_conditioner_with_noop_tokenizer_matches_jax():
    """The builder's default LUT tokenizer is the JAX package's: noop."""
    cfg = {"conditioners": {"genre": {"model": "lut", "lut": {
        "n_bins": 64, "dim": 6}}}}
    port = tbuilders.get_conditioners(6, cfg, device="cpu")["genre"]
    jlut = jcond.LUTConditioner(n_bins=64, dim=6, output_dim=6)
    texts = ["rock", None, "classical music"]
    for (a, b) in zip(port.tokenize(texts), jlut.tokenize(texts)):
        np.testing.assert_array_equal(a, b)


def test_t5_conditioner_tokenize_is_the_hash_fallback():
    """The port's T5 conditioner gives the ids of the JAX package's fallback
    (`WhiteSpaceTokenizer(n_bins=32128)` on the texts, empty -> None)."""
    cond = tcond.T5Conditioner(output_dim=8, config=tt5.T5EncoderConfig(
        **_cfg(False)))
    tok, mask = cond.tokenize(TEXTS)
    jtok, jmask = jcond.WhiteSpaceTokenizer(n_bins=32128)(
        [t if t else None for t in TEXTS])
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(mask, jmask)


def test_t5_conditioner_forward_matches_jax_encoder_and_projection():
    """Embeddings = mask * output_proj(T5(tokens)); padded steps are zero.
    (The JAX conditioner builds its encoder from a named preset only, so the
    reference is its T5Encoder plus the projection.)"""
    cfg = _cfg(False)
    cond = tcond.T5Conditioner(output_dim=8,
                               config=tt5.T5EncoderConfig(**cfg))
    tokens, mask = cond.tokenize(["a b c", "d"])
    tokens = tokens % cfg["vocab_size"]
    enc = jt5.T5Encoder(jt5.T5EncoderConfig(**cfg))
    params = enc.init(jax.random.PRNGKey(3), tokens, mask)
    w = np.random.RandomState(4).randn(64, 8).astype(np.float32)
    b = np.random.RandomState(5).randn(8).astype(np.float32)
    expected = (np.asarray(enc.apply(params, tokens, mask)) @ w + b) \
        * mask[..., None]
    jax_weights.load_t5(cond.t5, jax.tree.map(np.asarray, params))
    cond.output_proj.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                                      "bias": torch.from_numpy(b)})
    emb, got_mask = cond((tokens, mask))
    np.testing.assert_allclose(emb.detach().numpy(), expected, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got_mask.numpy(), mask)


def test_lut_conditioner_and_cfg_dropout_match_jax():
    lut = jcond.LUTConditioner(n_bins=50, dim=6, output_dim=6,
                               tokenizer="whitespace")
    attrs = [jcond.ConditioningAttributes(text={"description": t})
             for t in ["warm synth pad", "drums"]]
    null = jcond.ClassifierFreeGuidanceDropout(p=1.0)(attrs)
    assert [a.text for a in null] == [{"description": None}] * 2
    tokens, mask = lut.tokenize([a.text["description"] for a in attrs + null])
    params = lut.init(jax.random.PRNGKey(6), (tokens, mask))
    expected, _ = lut.apply(params, (tokens, mask))

    port = tcond.LUTConditioner(n_bins=50, dim=6, output_dim=6)
    p = jax.tree.map(np.asarray, params)["params"]
    port.embed.weight.data = torch.from_numpy(p["embed"]["embedding"].copy())
    port.output_proj.weight.data = torch.from_numpy(
        p["output_proj"]["kernel"].T.copy())
    port.output_proj.bias.data = torch.from_numpy(p["output_proj"]["bias"].copy())
    tattrs = [tcond.ConditioningAttributes(text={"description": t})
              for t in ["warm synth pad", "drums"]]
    tnull = tcond.ClassifierFreeGuidanceDropout(p=1.0)(tattrs)
    assert [a.text for a in tattrs] == [a.text for a in attrs]  # not mutated
    ttokens, tmask = port.tokenize([a.text["description"]
                                    for a in tattrs + tnull])
    np.testing.assert_array_equal(ttokens, tokens)
    emb, _ = port((ttokens, tmask))
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(expected),
                               atol=1e-6, rtol=1e-5)
