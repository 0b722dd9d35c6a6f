"""The port's MusicGen-Style path vs the JAX package on the same inputs and
weights (small sizes, f32, greedy decoding on the CPU): MERT, the style
conditioner on both feature paths (EnCodec codes and MERT states) with its
batch-norm statistics and RVQ codebooks carried across, the style knobs,
the two-condition prepend, and `debug-style` generation under batched and
double CFG; the training half: the RVQ's training forward and EMA codebook
update, the style conditioner's training forward, and a solver step of the
style LM. The same paths on the card are tested in `test_torch_gpu.py`.

The JAX feature extractor draws its excerpt's start from an unseeded numpy
RandomState, the port from its own generator; so every waveform here is
no longer than the excerpt (it is zero-padded, and both take all of it) or
the excerpt is taken from the middle (`use_middle_of_segment`).

Tolerances:
- MERT hidden states: atol 1e-4 (layer-normed outputs of order 1, f32
  convolutions and attention summed in another order);
- style embeddings: atol 1e-5 (outputs of order 0.1-1 after the RVQ's
  decode, which is exact once the codes agree: the codes are held equal);
- greedy tokens: equal; waveforms atol 1e-4 / rtol 1e-3 (f32 codec decode
  of equal codes, as `test_torch_musicgen.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules import mert as jmert
from audiocraft_tpu_torch.models import MusicGen, builders
from audiocraft_tpu_torch.modules import conditioners, mert
from audiocraft_tpu_torch.modules.conditioners import (
    ConditionFuser, StyleConditioner, WavCondition, bind_feat_extractor)
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

TEXTS = ["happy rock with loud drums", "jazz"]
WAV_TOL = dict(atol=1e-4, rtol=1e-3)
TINY_MERT = dict(hidden=32, num_layers=2, num_heads=1, intermediate=64,
                 conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2),
                 conv_stride=(5, 2, 2), pos_kernel=8, pos_groups=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _music(batch: int, samples: int, seed: int, channels: int = 1
           ) -> np.ndarray:
    """[batch, channels, samples] of seeded harmonics and a little noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(samples) / 32000
    rows = []
    for _ in range(batch):
        f0 = 110.0 * 2 ** (rs.randint(0, 24) / 12)
        wav = sum(rs.rand() / h * np.sin(2 * np.pi * h * f0 * t + 6 * rs.rand())
                  for h in range(1, 5)) + 0.01 * rs.randn(samples)
        rows.append(np.stack([wav] * channels))
    return (0.3 * np.stack(rows)).astype(np.float32)


def _conds(wav: np.ndarray, lengths, sr: int = 32000):
    """The same collated waveform condition for both packages."""
    return (WavCondition(torch.from_numpy(wav), torch.tensor(lengths),
                         [sr] * len(lengths), [None] * len(lengths)),
            jcond.WavCondition(wav, np.array(lengths), [sr] * len(lengths),
                               [None] * len(lengths)))


# ------------------------------------------------------------------- MERT

@pytest.fixture(scope="module")
def tiny_mert():
    jm = jmert.MERTModel(**TINY_MERT)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 800)))
    port = mert.MERTModel(**TINY_MERT, layer_norm_eps=1e-6).eval()
    jax_weights.load_mert(port, _np(params))
    return jm, params, port


@pytest.mark.parametrize("T", [2400, 1237])
def test_mert_forward_matches_jax(tiny_mert, T):
    jm, params, port = tiny_mert
    wav = np.random.RandomState(T).randn(2, T).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(wav)))
    with torch.no_grad():
        got = port(torch.from_numpy(wav)).numpy()
    frames = T
    for k, s in zip(TINY_MERT["conv_kernel"], TINY_MERT["conv_stride"]):
        frames = (frames - k) // s + 1
    assert got.shape == want.shape == (2, frames, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _hf_state(port: mert.MERTModel, naming: str) -> dict:
    """The port's weights as a Hugging Face MERT checkpoint: `hubert.`
    prefix, the positional conv weight-normed under `naming`, and the
    unused `masked_spec_embed`."""
    state = {f"hubert.{k}": v.clone() for k, v in port.state_dict().items()}
    w = state.pop("hubert.encoder.pos_conv_embed.conv.weight")
    g = w.square().sum(dim=(0, 1), keepdim=True).sqrt()
    v = w * 2.0
    keys = {"old": ("weight_g", "weight_v"),
            "new": ("parametrizations.weight.original0",
                    "parametrizations.weight.original1")}[naming]
    state[f"hubert.encoder.pos_conv_embed.conv.{keys[0]}"] = g
    state[f"hubert.encoder.pos_conv_embed.conv.{keys[1]}"] = v
    state["hubert.masked_spec_embed"] = torch.zeros(32)
    return state


@pytest.mark.parametrize("naming", ["old", "new"])
def test_mert_loads_a_hugging_face_checkpoint(tiny_mert, tmp_path, naming,
                                              monkeypatch):
    """A `pytorch_model.bin` with HubertModel's names loads by name, its
    shape read from the weights; the JAX package's loader reads the same
    file into the same function."""
    _, _, port = tiny_mert
    torch.save(_hf_state(port, naming), tmp_path / "pytorch_model.bin")
    loaded = mert.load_mert(tmp_path, layer_norm_eps=1e-6)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=1e-6,
                                   atol=1e-6)
    wav = np.random.RandomState(4).randn(1, 1600).astype(np.float32)
    jm, jparams = jax_load(tmp_path)
    with torch.no_grad():
        got = loaded(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(jparams, jnp.asarray(
        wav))), rtol=0, atol=1e-4)
    monkeypatch.setenv("MERT_CHECKPOINT", str(tmp_path))
    assert mert.find_mert_checkpoint() == tmp_path


def jax_load(path):
    from audiocraft_tpu.utils.torch_port import load_mert_from_path
    return load_mert_from_path(path)


def test_mert_refuses_safetensors_and_finds_nothing(tmp_path, monkeypatch):
    """An empty (truncated) `model.safetensors` is refused by the reader; a
    whole one loads (`test_torch_checkpoints.py`)."""
    (tmp_path / "model.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        mert.load_mert(tmp_path)
    monkeypatch.delenv("MERT_CHECKPOINT", raising=False)
    monkeypatch.setenv("AUDIOCRAFT_CACHE_DIR", str(tmp_path))
    assert mert.find_mert_checkpoint() is None and mert.get_mert("cpu") is None
    cond = StyleConditioner(8, model_name="mert", transformer_scale="none",
                            n_q_out=0, batch_norm=False, device="cpu")
    wav, _ = _conds(np.zeros((1, 1, 100), np.float32), [100])
    with pytest.raises(FileNotFoundError, match="MERT"):
        cond.tokenize(wav)


def test_full_width_mert_is_hubert_base():
    model = builders.get_mert_base(device="meta")
    assert sum(p.numel() for p in model.parameters()) == 94_370_816
    assert len(model.encoder.layers) == 12 and model.hidden == 768
    assert model.encoder.layers[0].feed_forward.intermediate_dense \
        .out_features == 3072


# --------------------------------------------------------------- debug-style

@pytest.fixture(scope="module")
def style_models():
    """The JAX debug-style model (its LM's bound codec serves as its codec
    too: the JAX package makes both from one seed) with seeded batch
    statistics, and the port's with the same weights."""
    jlm, jparams = jbuilders.get_debug_style_lm_model()
    codec, codec_vars = jlm.conditioners["self_wav"]._codec
    rs = np.random.RandomState(30)
    stats = jparams["batch_stats"]["conditioners_self_wav"]
    jparams = dict(jparams, batch_stats={"conditioners_self_wav": {
        "bn_mean": jnp.asarray(rs.randn(256).astype(np.float32) * 0.1),
        "bn_var": jnp.asarray(rs.rand(256).astype(np.float32) + 0.5)}})
    assert stats["bn_mean"].shape == (256,)
    jmg = JaxMusicGen("debug-style", codec, codec_vars, jlm, jparams,
                      max_duration=30)
    port_codec = builders.get_debug_compression_model(device="cpu")
    jax_weights.load_encodec(port_codec, _np(codec_vars))
    lm = builders.get_debug_style_lm_model(device="cpu")
    jax_weights.load_lm(lm, _np(jparams))
    style = lm.condition_provider.conditioners["self_wav"]
    jax_weights.load_encodec(style.feat_extractor, _np(codec_vars))
    return jmg, MusicGen("debug-style", port_codec, lm, max_duration=30,
                         device="cpu")


def _jax_style(jmg):
    """The JAX style conditioner and its variables."""
    name = "conditioners_self_wav"
    v = jmg.lm_params
    return jmg.lm.conditioners["self_wav"], {
        "params": v["params"][name], "batch_stats": v["batch_stats"][name],
        "quantizer": v["quantizer"][name]}


def _style_outputs(jmg, mg, wav, lengths):
    jstyle, jvars = _jax_style(jmg)
    style = mg.lm.condition_provider.conditioners["self_wav"]
    ours, theirs = _conds(wav, lengths)
    jt = jstyle.tokenize(theirs)
    want = jstyle.apply(jvars, jt)
    with torch.no_grad():
        tok = style.tokenize(ours)
        got = style(tok)
    return jt, tok, want, got


def test_style_statistics_and_codebooks_are_carried(style_models):
    jmg, mg = style_models
    style = mg.lm.condition_provider.conditioners["self_wav"]
    _, jvars = _jax_style(jmg)
    np.testing.assert_array_equal(style.batch_norm.running_mean.numpy(),
                                  np.asarray(jvars["batch_stats"]["bn_mean"]))
    np.testing.assert_array_equal(style.batch_norm.running_var.numpy(),
                                  np.asarray(jvars["batch_stats"]["bn_var"]))
    books = jvars["quantizer"]["style_rvq"].codebooks.embed
    assert len(style.rvq.vq.layers) == books.shape[0] == 3
    for q, layer in enumerate(style.rvq.vq.layers):
        np.testing.assert_array_equal(layer._codebook.embed.numpy(),
                                      np.asarray(books[q]))


def test_style_conditioner_encodec_path_matches_jax(style_models):
    """Codes, embeddings and mask, with a null row (length 0) that gives
    zeros and a zero mask."""
    jmg, mg = style_models
    wav = _music(3, 1500, seed=31)
    wav[2] = 0.0
    jt, tok, (je, jm), (pe, pm) = _style_outputs(jmg, mg, wav, [1500, 1100, 0])
    np.testing.assert_array_equal(tok["codes"].numpy(), np.asarray(jt["codes"]))
    np.testing.assert_array_equal(tok["valid"].numpy(), np.asarray(jt["valid"]))
    assert tuple(pe.shape) == (3, 1, 16)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert float(pe[2].abs().max()) == 0.0 and pm[:, 0].tolist() == [1, 1, 0]


@pytest.mark.parametrize("knobs", [
    dict(eval_q=1, excerpt_length=0.5),
    dict(eval_q=3, excerpt_length=0.5, ds_factor=3),
    dict(eval_q=2, excerpt_length=0.5, encodec_n_q=2)],
    ids=["eval_q1", "eval_q3_ds3", "encodec_n_q2"])
def test_set_style_conditioner_params_matches_jax(style_models, knobs):
    """The knobs change both packages alike: the RVQ streams at eval, the
    excerpt, the downsampling and the embedded codec streams."""
    jmg, mg = style_models
    jmg.set_style_conditioner_params(**knobs)
    mg.set_style_conditioner_params(**knobs)
    try:
        wav = _music(2, 15000, seed=32)
        jt, tok, (je, _), (pe, _) = _style_outputs(jmg, mg, wav, [15000, 15000])
        n_q = knobs.get("encodec_n_q", 4)
        assert tok["codes"].shape[1] == np.asarray(jt["codes"]).shape[1] == n_q
        frames = tok["codes"].shape[-1]
        assert pe.shape[1] == -(-frames // knobs.get("ds_factor", 2))
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0,
                                   atol=1e-5)
    finally:
        for model in (jmg, mg):
            model.set_style_conditioner_params(eval_q=2, excerpt_length=0.05,
                                               ds_factor=2, encodec_n_q=4)


def test_style_params_refuse_growth_and_other_models(style_models):
    _, mg = style_models
    with pytest.raises(AssertionError):
        mg.set_style_conditioner_params(eval_q=4)
    with pytest.raises(AssertionError, match="only be reduced"):
        mg.set_style_conditioner_params(eval_q=2, excerpt_length=0.05,
                                        encodec_n_q=5)
    with pytest.raises(AssertionError, match="MusicGen-Style"):
        MusicGen.get_pretrained("debug", device="cpu") \
            .set_style_conditioner_params()


def test_style_excerpt_draws_from_the_conditioner_generator(style_models):
    """Past the excerpt's length the start is drawn from the conditioner's
    own generator: equal seeds give equal excerpts; the middle is taken
    with `use_middle_of_segment`."""
    _, mg = style_models
    style = mg.lm.condition_provider.conditioners["self_wav"]
    wav = torch.arange(8000, dtype=torch.float32)[None, None]
    mg.set_seed(3)
    first = style._excerpt(wav)
    mg.set_seed(3)
    assert torch.equal(style._excerpt(wav), first) and first.shape[-1] == 1600
    style.use_middle_of_segment = True
    try:
        assert int(style._excerpt(wav)[0, 0, 0]) == (8000 - 1600) // 2
    finally:
        style.use_middle_of_segment = False


# ------------------------------------------------ training (RVQ, style, LM)

def _jax_books(rs, n_q, C, D):
    """A JAX RVQ state with seeded codebooks, EMA sums and cluster sizes
    (some below 1, so a dead-code threshold of 1 expires them)."""
    from audiocraft_tpu.quantization.core_vq import CodebookState, RVQState
    embed = rs.randn(n_q, C, D).astype(np.float32)
    size = (rs.rand(n_q, C) * 3).astype(np.float32)
    return RVQState(CodebookState(
        inited=jnp.ones((n_q,), bool), cluster_size=jnp.asarray(size),
        embed=jnp.asarray(embed),
        embed_avg=jnp.asarray(embed * size[..., None])))


def _port_books(state):
    from audiocraft_tpu_torch.quantization import ResidualVectorQuantization
    books = state.codebooks
    n_q, C, D = books.embed.shape
    rvq = ResidualVectorQuantization(n_q, D, C)
    for q, layer in enumerate(rvq.layers):
        for name in ("embed", "embed_avg", "cluster_size"):
            getattr(layer._codebook, name).copy_(
                torch.from_numpy(np.array(getattr(books, name)[q])))
    return rvq


def _assert_books_equal(rvq, state, atol):
    books = state.codebooks
    for q, layer in enumerate(rvq.layers):
        for name in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(
                getattr(layer._codebook, name).numpy(),
                np.asarray(getattr(books, name)[q]), rtol=0, atol=atol,
                err_msg=f"level {q} {name}")


@pytest.mark.parametrize("n_active", [1, 3])
def test_rvq_training_forward_matches_jax(n_active):
    """`rvq_forward` in training (no dead-code expiry): the quantized
    output, the codes of every level, the gated commitment losses, the
    codebooks after the EMA step, and the gradient through the
    straight-through estimator and the commitment losses (atol 1e-5)."""
    from audiocraft_tpu.quantization.core_vq import rvq_forward
    rs = np.random.RandomState(40 + n_active)
    state = _jax_books(rs, 3, 16, 8)
    x = rs.randn(2, 5, 8).astype(np.float32)
    w = rs.randn(2, 5, 8).astype(np.float32)

    def loss(x):
        q, codes, commits, new = rvq_forward(
            state, x, n_q_active=jnp.asarray(n_active), training=True,
            rng=jax.random.PRNGKey(3), threshold_ema_dead_code=0.0)
        return jnp.sum(q * w) + jnp.sum(commits), (q, codes, commits, new)
    (_, (jq, jcodes, jcommits, jstate)), jgrad = jax.value_and_grad(
        loss, has_aux=True)(jnp.asarray(x))
    rvq = _port_books(state)
    tx = torch.from_numpy(x).requires_grad_(True)
    q, codes, commits = rvq(tx, n_active, True, threshold_ema_dead_code=0.0)
    (q * torch.from_numpy(w)).sum().add(commits.sum()).backward()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(commits.detach().numpy(), np.asarray(jcommits),
                               atol=1e-5)
    assert (commits[n_active:] == 0).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-5)
    _assert_books_equal(rvq, jstate, atol=1e-5)


def test_ema_codebook_update_expires_dead_codes_as_jax():
    """A threshold of 1 with the replacement rows the JAX function draws
    injected: expired codes take them, the rest their EMA (atol 1e-5)."""
    from audiocraft_tpu.quantization.core_vq import (ema_codebook_update,
                                                     sample_vectors)
    from audiocraft_tpu_torch.quantization import core_vq
    rs = np.random.RandomState(44)
    state = _jax_books(rs, 1, 16, 8)
    level = jax.tree.map(lambda a: a[0], state.codebooks)
    flat = rs.randn(40, 8).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    new = ema_codebook_update(level, jnp.asarray(flat), None, rng, decay=0.9,
                              epsilon=1e-5, threshold_ema_dead_code=1.0)
    replacement = sample_vectors(jax.random.split(rng)[1], jnp.asarray(flat),
                                 16)
    book = _port_books(state).layers[0]._codebook
    expired = book.cluster_size < 1.0
    assert 0 < int(expired.sum()) < 16
    core_vq.ema_codebook_update(
        book, torch.from_numpy(flat), decay=0.9, epsilon=1e-5,
        threshold_ema_dead_code=1.0,
        replacement=torch.from_numpy(np.array(replacement)))
    for name in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(book, name).numpy(),
                                   np.asarray(getattr(new, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert torch.equal(book.embed[expired],
                       torch.from_numpy(np.array(replacement))[expired])
    # without injected rows, the rows come from the generator: the batch's
    g = torch.Generator().manual_seed(0)
    core_vq.ema_codebook_update(book, torch.from_numpy(flat), decay=0.9,
                                epsilon=1e-5, threshold_ema_dead_code=5.0,
                                generator=g)
    rows = torch.from_numpy(flat)
    assert all(any(torch.equal(e, r) for r in rows) for e in book.embed)


def test_style_training_forward_matches_jax(style_models):
    """A direct call of the conditioner in training mode: the JAX
    `__call__(training=True)` with 'batch_stats' and 'quantizer' mutable.
    The JAX package draws the RVQ streams from the fixed key PRNGKey(1);
    the port takes that count as `n_q`; no dead-code expiry (threshold 0).
    Embeddings and mask, the running statistics and every codebook after
    the step (atol 1e-5)."""
    import copy
    jmg, mg = style_models
    jstyle, jvars = _jax_style(jmg)
    style = copy.deepcopy(mg.lm.condition_provider.conditioners["self_wav"])
    style.rvq.threshold_ema_dead_code = 0.0
    ours, theirs = _conds(_music(3, 1500, seed=45), [1500, 1200, 1500])
    jt = jstyle.tokenize(theirs)
    tok = style.tokenize(ours)
    (je, jm), new_vars = jstyle.clone(rvq_threshold_ema_dead_code=0.0).apply(
        jvars, jt, training=True, mutable=["batch_stats", "quantizer"])
    drng = jax.random.split(jax.random.PRNGKey(1))[1]
    n_q = int(jax.random.randint(drng, (), 1, style.n_q_out + 1))
    style.train()
    pe, pm = style(tok, n_q=n_q)
    np.testing.assert_allclose(pe.detach().numpy(), np.asarray(je), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    stats = new_vars["batch_stats"]
    np.testing.assert_allclose(style.batch_norm.running_mean.numpy(),
                               np.asarray(stats["bn_mean"]), atol=1e-5)
    np.testing.assert_allclose(style.batch_norm.running_var.numpy(),
                               np.asarray(stats["bn_var"]), atol=1e-5)
    assert int(style.batch_norm.num_batches_tracked) == 1
    _assert_books_equal(style.rvq.vq, new_vars["quantizer"]["style_rvq"],
                        atol=1e-5)
    # the eval forward afterwards reads the updated statistics
    style.eval()
    with torch.no_grad():
        assert torch.isfinite(style(tok)[0]).all()


def test_style_lm_solver_step_matches_jax_train_step(style_models):
    """The repair: `MusicGenSolver.run_step` on the debug style LM gives
    the JAX `make_train_step`'s CE and every gradient, with the
    style conditioner in its eval forward as the JAX provider calls it
    (1e-5 relative to each tensor's largest entry); its statistics and
    codebooks do not move."""
    import copy
    import optax
    from audiocraft_tpu.models import lm as jlm
    from audiocraft_tpu.solvers import musicgen as jsolver
    from audiocraft_tpu_torch.solvers import builders as solver_builders
    from audiocraft_tpu_torch.solvers import musicgen as tsolver
    jmg, mg = style_models
    rs = np.random.RandomState(46)
    wav = _music(2, 1500, seed=47)
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    jattrs = jmg._prepare_tokens_and_attributes(TEXTS, None)[0]
    for i in range(2):
        attrs[i].wav["self_wav"] = WavCondition(
            torch.from_numpy(wav[i:i + 1]), torch.tensor([1500]), [32000],
            [None])
        jattrs[i].wav["self_wav"] = jcond.WavCondition(
            wav[i:i + 1], np.array([1500]), [32000], [None])
    codes = rs.randint(0, mg.lm.card, (2, 4, 9))
    jlm_model, params = jmg.lm, jmg.lm_params
    tokenized = jlm.tokenize_conditions(jlm_model, jattrs)
    # an optimizer that keeps the gradients as its state and updates nothing
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step = jsolver.make_train_step(jlm_model, keep)
    # the step donates its state: hand it a copy of the fixture's weights
    new_state, jmetrics = step(jsolver.init_train_state(
        jlm_model, jax.tree.map(jnp.copy, params), keep), jnp.asarray(codes),
        tokenized, None, jax.random.PRNGKey(0))
    expected = jax_weights.lm_state(mg.lm, jax.tree.map(
        np.asarray, dict(params, params=new_state.opt_state)))

    solver = tsolver.MusicGenSolver({"seed": 0}, device="cpu")
    solver.model = copy.deepcopy(mg.lm)
    solver.optimizer = solver_builders.get_optimizer(
        [p for p in solver.model.parameters() if p.requires_grad],
        {"lr": 0.0})
    style = solver.model.condition_provider.conditioners["self_wav"]
    before = {k: v.clone() for k, v in style.state_dict().items()
              if "batch_norm" in k or "rvq" in k}
    batch = {"codes": torch.from_numpy(codes),
             "tokenized": solver.model.condition_provider.tokenize(attrs)}
    metrics = solver.run_step(0, batch, {})
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]),
                               rtol=1e-5)
    named = dict(solver.model.named_parameters())
    assert set(named) == {k for k in expected if k in named}
    for name, p in named.items():
        want = expected[name]
        if p.grad is None:  # behind the RVQ's codes: no gradient reaches it
            assert not np.any(want), name
            continue
        scale = max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name)
    after = style.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


def test_two_prepended_conditions_match_jax(style_models):
    """Style and text both prepended (the `style2music` fuser): the
    provider yields the text first, then the waveform, so the prefix is
    [style, text] and its length their sum, in both packages."""
    jmg, mg = style_models
    from audiocraft_tpu.models import lm as jlm
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    jattrs = jmg._prepare_tokens_and_attributes(TEXTS, None)[0]
    wav = _music(2, 1500, seed=34)
    for i in range(2):
        attrs[i].wav["self_wav"] = WavCondition(
            torch.from_numpy(wav[i:i + 1]), torch.tensor([1500]), [32000],
            [None])
        jattrs[i].wav["self_wav"] = jcond.WavCondition(
            wav[i:i + 1], np.array([1500]), [32000], [None])
    with torch.no_grad():
        ct = mg.lm.compute_conditions(mg.lm.condition_provider.tokenize(attrs))
    jct = jlm.jit_compute_conditions(jmg.lm, jmg.lm_params,
                                     jlm.tokenize_conditions(jmg.lm, jattrs))
    assert list(ct) == list(jct) == ["description", "self_wav"]
    fuse = {"prepend": ["self_wav", "description"], "cross": [], "sum": []}
    x = np.random.RandomState(35).randn(2, 3, 16).astype(np.float32)
    want, _ = jcond.ConditionFuser(fuse)(jnp.asarray(x), jct)
    fuser = ConditionFuser(fuse)
    got, cross = fuser(torch.from_numpy(x), ct)
    assert cross is None
    n_text, n_style = ct["description"][0].shape[1], ct["self_wav"][0].shape[1]
    assert fuser.prepend_length(ct) == n_style + n_text == want.shape[1] - 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, :n_style].numpy(),
                                  ct["self_wav"][0].numpy())


CFG_MODES = {"batched": {}, "double": {"cfg_coef_beta": 5.0}}


def _generate(jmg, mg, wav, sr, kw):
    for model in (jmg, mg):
        model.set_generation_params(duration=0.5, use_sampling=False, **kw)
    jw, jt = jmg.generate_with_chroma(TEXTS, wav, sr, return_tokens=True)
    pw, pt = mg.generate_with_chroma(TEXTS, torch.from_numpy(wav), sr,
                                     return_tokens=True)
    return np.asarray(jw), np.asarray(jt), pw.numpy(), pt.numpy()


@pytest.mark.parametrize("mode", list(CFG_MODES))
def test_debug_style_generation_matches_jax(style_models, mode):
    """1500 samples at 32 kHz, within the 0.05 s excerpt: one style token
    per row."""
    jw, jt, pw, pt = _generate(*style_models, _music(2, 1500, seed=36),
                               32000, CFG_MODES[mode])
    assert pt.shape == (2, 4, 12) and pw.shape == (2, 1, 12 * 1280)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pw, jw, **WAV_TOL)


@pytest.mark.parametrize("mode", list(CFG_MODES))
def test_debug_style_longer_excerpt_matches_jax(style_models, mode):
    """0.4 s of 44.1 kHz stereo within a 0.5 s excerpt at all 3 RVQ
    streams: 7 style tokens per row."""
    jmg, mg = style_models
    for model in (jmg, mg):
        model.set_style_conditioner_params(eval_q=3, excerpt_length=0.5)
    try:
        jw, jt, pw, pt = _generate(jmg, mg, _music(2, 17640, seed=37,
                                                   channels=2),
                                   44100, CFG_MODES[mode])
    finally:
        for model in (jmg, mg):
            model.set_style_conditioner_params(eval_q=2, excerpt_length=0.05)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pw, jw, **WAV_TOL)


def test_debug_style_from_get_pretrained_runs():
    mg = MusicGen.get_pretrained("debug-style", device="cpu")
    mg.set_generation_params(duration=0.5, use_sampling=False)
    wav, tokens = mg.generate_with_chroma(["calm"], torch.from_numpy(
        _music(1, 1000, seed=38)[0]), 32000, return_tokens=True)
    assert tuple(wav.shape) == (1, 1, 12 * 1280) and tuple(tokens.shape) == (1, 4, 12)
    assert torch.isfinite(wav).all()
    _, text_only = mg.generate(["calm"], return_tokens=True)
    assert tuple(text_only.shape) == (1, 4, 12)


# ------------------------------------------------------------- MERT path

def test_style_conditioner_mert_path_matches_jax(tiny_mert, tmp_path,
                                                 monkeypatch):
    """The `mert` features: the excerpt resampled to 24 kHz mono through
    a tiny MERT read from one checkpoint by both packages, with a null
    row; the 'xsmall' transformer, the batch norm and 2 of 3 RVQ streams."""
    _, _, port_mert = tiny_mert
    torch.save(_hf_state(port_mert, "old"), tmp_path / "pytorch_model.bin")
    monkeypatch.setenv("MERT_CHECKPOINT", str(tmp_path))
    jmert._MERT_CACHE.clear()
    # loaded at top level first: built inside the unbound conditioner's
    # tokenize, flax would make the MERTModel its submodule and raise
    jmert.get_mert()
    kw = dict(sample_rate=32000, transformer_scale="xsmall", ds_factor=2,
              n_q_out=3, eval_q=2, length=0.1, bins=64)
    jstyle = jcond.StyleConditioner(dim=256, output_dim=16, model_name="mert",
                                    **kw)
    wav = _music(3, 2500, seed=39)
    wav[1] = 0.0
    ours, theirs = _conds(wav, [2500, 0, 1800])
    jt = jstyle.tokenize(theirs)
    jvars = jstyle.init(jax.random.PRNGKey(1), jt)
    rs = np.random.RandomState(40)
    jvars = dict(jvars, batch_stats={"bn_mean": jnp.asarray(
        rs.randn(256).astype(np.float32) * 0.1), "bn_var": jnp.asarray(
        rs.rand(256).astype(np.float32) + 0.5)})
    want, jmask = jstyle.apply(jvars, jt)
    style = StyleConditioner(16, model_name="mert", mert_hidden=32,
                             device="cpu", **kw).eval()
    jax_weights.load_style(style, _np(jvars))
    bind_feat_extractor(style, mert.load_mert(tmp_path, layer_norm_eps=1e-6))
    with torch.no_grad():
        tok = style.tokenize(ours)
        got, mask = style(tok)
    np.testing.assert_allclose(tok["mert"].numpy(), np.asarray(jt["mert"]),
                               rtol=0, atol=1e-4)
    assert tuple(got.shape) == (3, 60, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(got[1].abs().max()) == 0.0
    jmert._MERT_CACHE.clear()


def test_style_builders_at_full_width():
    """MusicGen-Style's medium LM: MERT of HuBERT-base bound, the style
    transformer 'default' (8 layers of 512), 6 x 1024 RVQ codes with 3 at
    eval, style then text prepended, no cross-attention; built on the meta
    device (shapes only)."""
    lm = builders.get_musicgen_style_lm(device="meta")
    style = lm.condition_provider.conditioners["self_wav"]
    assert isinstance(style, StyleConditioner) and style.model_name == "mert"
    assert (lm.dim, lm.num_heads, lm.num_layers) == (1536, 24, 48)
    assert lm.fuser.fuse2cond["prepend"] == ["self_wav", "description"]
    assert not lm.cross_attention
    assert len(style.transformer.layers) == 8 and style.dim == 512
    assert (len(style.rvq.vq.layers), style.rvq.bins, style.eval_q,
            style.ds_factor) == (6, 1024, 3, 15)
    assert isinstance(style.feat_extractor, mert.MERTModel)
    # 3 s of 75 Hz MERT frames every 15th step: 15 style tokens
    assert -(-int(3 * 75) // style.ds_factor) == 15
    assert isinstance(conditioners.FeatureExtractor(16, device="meta").embed,
                      torch.nn.ModuleList)


CODEC_CFG = {"compression_model": "encodec", "sample_rate": 32000,
             "channels": 1,
             "seanet": {"dimension": 32, "n_filters": 4,
                        "n_residual_layers": 1, "ratios": [10, 8, 16],
                        "lstm": 0, "norm": "none"},
             "rvq": {"n_q": 4, "bins": 400}}
STYLE_LM_CFG = {
    "transformer_lm": {"n_q": 4, "card": 400, "dim": 16, "num_heads": 4,
                       "num_layers": 2, "hidden_scale": 4, "causal": True},
    "conditioners": {
        "description": {"model": "lut", "lut": {
            "n_bins": 128, "dim": 16, "tokenizer": "whitespace"}},
        "self_wav": {"model": "style", "style": {
            "model_name": "mert", "transformer_scale": "xsmall",
            "sample_rate": 32000, "length": 0.1, "ds_factor": 2,
            "n_q_out": 3, "eval_q": 2, "bins": 64, "mert_hidden": 32}}},
    "fuser": {"prepend": ["self_wav", "description"], "cross": [], "sum": [],
              "input_interpolate": []},
    "classifier_free_guidance": {"inference_coef": 3.0},
    "dataset": {"segment_duration": 30}}


def test_style_package_loads_with_upstream_names(tiny_mert, tmp_path,
                                                 monkeypatch):
    """A style LM saved as an export package keeps upstream's names (the
    batch norm's buffers, the RVQ codebooks, the embed and transformer of
    the conditioner), loads strictly, and finds its MERT at tokenize time
    through `$MERT_CHECKPOINT`."""
    _, _, port_mert = tiny_mert
    lm = builders.get_lm_model(STYLE_LM_CFG, device="cpu", seed=41)
    codec = builders.get_debug_compression_model(device="cpu", seed=42)
    state = lm.state_dict()
    prefix = "condition_provider.conditioners.self_wav."
    for key in ("batch_norm.running_mean", "batch_norm.running_var",
                "rvq.vq.layers.2._codebook.embed", "embed.weight",
                "transformer.layers.3.self_attn.in_proj_weight",
                "output_proj.weight"):
        assert prefix + key in state, key
    torch.save({"best_state": state, "xp.cfg": STYLE_LM_CFG},
               tmp_path / "state_dict.bin")
    torch.save({"best_state": codec.state_dict(), "xp.cfg": CODEC_CFG},
               tmp_path / "compression_state_dict.bin")
    (tmp_path / "mert").mkdir()
    torch.save(_hf_state(port_mert, "new"),
               tmp_path / "mert" / "pytorch_model.bin")
    monkeypatch.setenv("MERT_CHECKPOINT", str(tmp_path / "mert"))
    mg = MusicGen.get_pretrained(str(tmp_path), device="cpu")
    for key, value in state.items():
        assert torch.equal(mg.lm.state_dict()[key], value), key
    mg.set_generation_params(duration=0.2, use_sampling=False)
    _, tokens = mg.generate_with_chroma(["calm"], torch.from_numpy(
        _music(1, 2000, seed=43)[0]), 32000, return_tokens=True)
    assert tuple(tokens.shape) == (1, 4, 5)
    style = mg.lm.condition_provider.conditioners["self_wav"]
    assert isinstance(style._mert(), mert.MERTModel)
