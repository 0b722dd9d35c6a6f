"""The CLAP joint-embedding conditioning of the port (`modules/clap.py`,
the joint conditions of `modules/conditioners.py`, the `clap` kind of
`models/builders.py`) against the JAX package on the CPU, on the same
seeded inputs:

- `clap_mel` and the bicubic time matrix;
- the audio tower (a 200-frame input, resized to the grid, and the exact
  256-frame grid) and the text tower, read by both packages from one
  checkpoint file the port writes: its `state_dict()` in the Hugging Face
  layout through the port's safetensors writer, and the same weights in
  the laion_clap layout (fused qkv, `torch.save`); `jax_weights.load_clap`
  carries the JAX parameter tree back;
- the port's byte-level BPE tokenizer against `transformers.
  RobertaTokenizer` on the character-level fixture files of
  `tests/models/test_clap_conditioner.py` and on a small real merges list
  (skipped where `transformers` is absent);
- `CLAPEmbeddingConditioner`: text embeddings at eval (with the null row),
  audio embeddings in training (windows of a 12 s clip, and a nulled row),
  the draw of `text_p` from the seeded host generator, and the RVQ and
  output projection from the JAX variables;
- the provider's collate of joint conditions (a sample without one gets
  the null condition) and their nullify under attribute and CFG dropout;
- `builders.get_conditioners` on `conditioner/clapemb2music`;
- a tiny LM conditioned by CLAP: greedy tokens equal to JAX's, for
  attributes whose joint condition carries the texts and for text-only
  attributes (what `MusicGen.generate` builds: every row the null
  condition, in both packages).

The tower is tiny: 16 mel bins on a 64 x 4 grid, patch 4, window 4, two
stages of 2 blocks (16 and 32 wide, 2 heads), text 2 layers of 32,
projections of 20.

Tolerances: mel atol 1e-4 dB; the bicubic matrix exact; embeddings atol
1e-5 (f32 towers, unit-norm outputs); token ids equal; conditioner outputs
atol 1e-5; greedy tokens equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import lm as jlm
from audiocraft_tpu.modules import clap as jclap
from audiocraft_tpu.modules import conditioners as jcond
from audiocraft_tpu.modules.patterns import \
    DelayedPatternProvider as JDelayedPatternProvider
from audiocraft_tpu_torch.config import load_config
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.models.lm import GenParams, LMModel
from audiocraft_tpu_torch.modules import clap, conditioners as pcond
from audiocraft_tpu_torch.modules.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.utils import jax_weights, safetensors
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

TINY = clap.CLAPConfig(
    num_mel_bins=16, spec_size=64, freq_ratio=4, patch_size=4,
    patch_embeds_hidden_size=16, window_size=4, depths=[2, 2],
    num_heads=[2, 2], vocab_size=400, text_hidden_size=32,
    text_num_layers=2, text_num_heads=2, text_intermediate_size=64,
    max_position_embeddings=80, projection_dim=20)
TEXTS = ["warm piano", "fast drums and 2 guitars!", "", "ünïcode_under__score"]


def _tiny_model(seed=0) -> clap.ClapModel:
    torch.manual_seed(seed)
    model = clap.ClapModel(TINY).eval()
    bn = model.audio_model.audio_encoder.batch_norm
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.running_mean.normal_(0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        bn.weight.normal_(1, 0.1, generator=g)
    return model


def _laion(state: dict) -> dict:
    """The Hugging Face layout of `state` re-keyed as laion_clap's."""
    renames = [(".layernorm_before.", ".norm1."),
               (".layernorm_after.", ".norm2."),
               (".attention.output.dense.", ".attn.proj."),
               (".attention.self.relative_position_bias_table",
                ".attn.relative_position_bias_table"),
               (".intermediate.dense.", ".mlp.fc1."),
               (".output.dense.", ".mlp.fc2.")]
    out = {}
    for k, v in state.items():
        if k.startswith("text_model."):
            k = "module.text_branch." + k[len("text_model."):]
        elif k.startswith("audio_model.audio_encoder.batch_norm."):
            k = "module.audio_branch.bn0." + k.rsplit(".", 1)[-1]
        elif k.startswith("audio_model.audio_encoder."):
            k = "module.audio_branch." + k[len("audio_model.audio_encoder."):]
            for old, new in renames:
                k = k.replace(old, new)
        else:
            tower, lin, leaf = k.split(".")
            k = f"module.{tower}.{0 if lin == 'linear1' else 2}.{leaf}"
        out[k] = v
    fused = {}
    for k, v in out.items():
        if ".attention.self.query." in k and "audio_branch" in k:
            stem, leaf = k.split(".attention.self.query.")
            fused[f"{stem}.attn.qkv.{leaf}"] = torch.cat(
                [v, out[f"{stem}.attention.self.key.{leaf}"],
                 out[f"{stem}.attention.self.value.{leaf}"]])
        elif not (("audio_branch" in k) and (".attention.self.key." in k or
                                             ".attention.self.value." in k)):
            fused[k] = v
    return fused


def _char_tokenizer_dir(d):
    """The character-level fixture of tests/models/test_clap_conditioner.py
    (a-z and Ġ, no merges), with ids for the specials."""
    d.mkdir(exist_ok=True)
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["Ġ"]
    specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(specials + chars)}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return d


MERGES = [("Ġ", "w"), ("a", "r"), ("Ġw", "ar"), ("Ġwar", "m"), ("i", "a"),
          ("n", "o"), ("Ġ", "p"), ("Ġp", "ia"), ("Ġpia", "no"), ("r", "u"),
          ("Ġ", "d"), ("Ġd", "ru"), ("m", "s"), ("Ġ", "a"), ("n", "d"),
          ("Ġa", "nd"), ("Ġ", "2"), ("u", "i"), ("t", "a"), ("Ġ", "g"),
          ("Ġg", "ui"), ("Ġgui", "ta"), ("Ġguita", "r"), ("s", "t"),
          ("_", "_"), ("Ġ", "Ġ")]


def _bpe_tokenizer_dir(d):
    """Byte-level vocabulary (every byte's character) plus the merges."""
    d.mkdir(exist_ok=True)
    specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    tokens = specials + sorted(set(clap._bytes_to_unicode().values()))
    tokens += ["".join(m) for m in MERGES]
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(dict.fromkeys(tokens))}))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES))
    return d


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The port's tiny CLAP written in the Hugging Face layout (safetensors,
    with the byte-level tokenizer files beside it) and in laion's."""
    d = tmp_path_factory.mktemp("clap")
    model = _tiny_model()
    safetensors.save_file(model.state_dict(), d / "clap.safetensors")
    torch.save({"state_dict": _laion(model.state_dict())}, d / "laion.pt")
    _bpe_tokenizer_dir(d)
    return model, d


# ------------------------------------------------------------ preprocessing
def test_clap_mel_and_bicubic_match_jax():
    wav = (0.3 * np.random.RandomState(0).randn(30000)).astype(np.float32)
    np.testing.assert_allclose(clap.clap_mel(wav, n_mels=16),
                               jclap.clap_mel(wav, n_mels=16), atol=1e-4,
                               rtol=0)
    for n_in, n_out in ((200, 256), (1001, 1024), (5, 5)):
        np.testing.assert_array_equal(clap._bicubic_time_matrix(n_in, n_out),
                                      jclap._bicubic_time_matrix(n_in, n_out))


# ------------------------------------------------------------------ towers
@pytest.mark.parametrize("layout, frames", [("hf", 200), ("hf", 256),
                                            ("laion", 200)])
def test_towers_match_jax(ckpt, layout, frames):
    model, d = ckpt
    path = d / ("clap.safetensors" if layout == "hf" else "laion.pt")
    jparams, jcfg = jclap.load_clap_params(path, text_num_heads=2)
    port = clap.load_clap_model(path, device="cpu", text_num_heads=2)
    for k, v in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    mel = (20 * np.random.RandomState(frames).randn(2, frames, 16)
           - 30).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, m: jclap.clap_audio_apply(
        p, jcfg, m))(jparams, jnp.asarray(mel)))
    got = port.get_audio_features(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ids = np.random.RandomState(3).randint(2, 400, size=(3, 12))
    mask = np.ones((3, 12), np.int64)
    ids[1, 8:], mask[1, 8:], ids[:, 0] = 1, 0, 0
    want = np.asarray(jclap.clap_text_apply(jparams, jcfg, jnp.asarray(ids),
                                            jnp.asarray(mask)))
    got = port.get_text_features(torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the JAX tree carried back onto the port's names
    fresh = clap.ClapModel(TINY)
    jax_weights.load_clap(fresh, jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy())


def test_htsat_base_grid():
    """HTSAT-base's real grid: 1001 frames resized to 1024, folded to a
    256 x 256 image, 64 x 64 patches; windows of 8 shift on the 64, 32 and
    16 grids and not on the last (8 <= window); the relative index covers
    the 15 x 15 table."""
    cfg = clap.CLAPConfig()
    assert cfg.audio_hidden_size == 1024
    grids, H = [], 256 // cfg.patch_size
    for i in range(len(cfg.depths)):
        grids.append((H, H > cfg.window_size))
        H = (H + 1) // 2
    assert grids == [(64, True), (32, True), (16, True), (8, False)]
    index = clap._rel_position_index(8)
    assert index.shape == (64, 64) and index.min() == 0 \
        and index.max() == 15 * 15 - 1
    np.testing.assert_array_equal(index, jclap._rel_position_index(8))
    for Hp in (64, 32, 16):
        np.testing.assert_array_equal(clap._shift_attn_mask(Hp, Hp, 8, 4),
                                      jclap._shift_attn_mask(Hp, Hp, 8, 4))
    emb = clap.CLAPEmbedder(clap.ClapModel(
        clap.CLAPConfig(text_num_layers=1, depths=[1, 1, 1, 1]),
        device="meta"))
    assert emb.max_samples == 480000


# --------------------------------------------------------------- tokenizer
@pytest.mark.parametrize("files", ["chars", "bpe"])
def test_tokenizer_matches_roberta(tmp_path, files):
    transformers = pytest.importorskip("transformers")
    d = (_char_tokenizer_dir if files == "chars" else _bpe_tokenizer_dir)(
        tmp_path / files)
    ref = transformers.RobertaTokenizer.from_pretrained(str(d))
    ours = clap.RobertaBPETokenizer.from_dir(d)
    texts = TEXTS + ["it's  the   rock'n'roll 1999 ...", "x" * 100,
                     "warm piano warm   piano\tpiano\n"]
    enc = ref(texts, padding=True, truncation=True, max_length=77,
              return_tensors="np")
    ids, mask = ours(texts)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


# -------------------------------------------------------------- conditioner
def _joint(texts, seconds, sr=16000, seed=0):
    B = len(texts)
    T = int(seconds * sr)
    wav = (0.1 * np.random.RandomState(seed).randn(B, 1, T)).astype(np.float32)
    return wav, dict(text=list(texts), length=np.full((B,), T),
                     sample_rate=[sr] * B, path=[None] * B,
                     seek_time=[None] * B)


def _conditioners(path, **kw):
    cfg = dict(load_config("conditioner/clapemb2music")["conditioners"]
               ["description"]["clap"])
    for k in ("attribute", "cache_path"):
        cfg.pop(k)
    cfg.update(checkpoint=str(path), dim=20, **kw)
    port = pcond.CLAPEmbeddingConditioner(output_dim=16, device="cpu", **cfg)
    cfg.pop("kmeans_iters", None)
    jax_cond = jcond.CLAPEmbeddingConditioner(output_dim=16,
                                              attribute="description", **cfg)
    return port, jax_cond


def test_conditioner_embeds_match_jax(ckpt):
    _, d = ckpt
    port, jax_cond = _conditioners(d / "clap.safetensors", quantize=False)
    wav, meta = _joint(TEXTS, 0.3)
    x = pcond.JointEmbedCondition(torch.from_numpy(wav), length=torch.as_tensor(
        meta.pop("length")), **meta)
    jx = jcond.JointEmbedCondition(wav, length=x.length.numpy(), **meta)
    embed, valid = port._get_embed(x)                 # eval: the texts
    jembed, jvalid = jax_cond._get_embed(jx)
    np.testing.assert_allclose(embed.numpy(), jembed, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert valid[:, 0].tolist() == [1, 1, 0, 1]
    # training with text_p 0: the audio, 12 s in 10 s windows every second,
    # and a nulled row
    wav, meta = _joint(["a", "b"], 12.0, seed=1)
    wav[1, :, 1:] = 0
    meta["sample_rate"] = [16000, 0]
    x = pcond.JointEmbedCondition(torch.from_numpy(wav), length=torch.as_tensor(
        meta.pop("length")), **meta)
    jx = jcond.JointEmbedCondition(wav, length=x.length.numpy(), **meta)
    pcond.set_joint_embed_train(port, True, seed=0)
    jcond.set_joint_embed_train(jax_cond, True, seed=0)
    embed, valid = port._get_embed(x)
    jembed, jvalid = jax_cond._get_embed(jx)
    np.testing.assert_allclose(embed.numpy(), jembed, atol=1e-5, rtol=0)
    assert valid[:, 0].tolist() == jvalid[:, 0].tolist() == [1, 0]
    # text_p 0.5: the same host draws choose text or audio in both
    port.text_p, jax_cond_p = 0.5, jcond.CLAPEmbeddingConditioner(
        output_dim=16, attribute="description", checkpoint=str(
            d / "clap.safetensors"), dim=20, text_p=0.5)
    pcond.set_joint_embed_train(port, True, seed=3)
    jcond.set_joint_embed_train(jax_cond_p, True, seed=3)
    for _ in range(3):
        np.testing.assert_allclose(port._get_embed(x)[0].numpy(),
                                   jax_cond_p._get_embed(jx)[0], atol=1e-5)


def test_conditioner_rvq_and_projection_match_jax(ckpt):
    _, d = ckpt
    port, jax_cond = _conditioners(d / "clap.safetensors", n_q=3, bins=16)
    wav, meta = _joint(TEXTS, 0.3)
    x = pcond.JointEmbedCondition(torch.from_numpy(wav), length=torch.as_tensor(
        meta.pop("length")), **meta)
    jx = jcond.JointEmbedCondition(wav, length=x.length.numpy(), **meta)
    jtok = jax_cond.tokenize(jx)
    variables = jax_cond.init(jax.random.PRNGKey(0), jtok)
    jax_weights.load_joint_conditioner(port, jax.tree.map(np.asarray,
                                                          variables))
    (want, wmask), _ = jax_cond.apply(variables, jtok, mutable=["quantizer"])
    got, mask = port(port.tokenize(x))
    assert got.shape == (4, 1, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert float(got[2].detach().abs().max()) == 0.0


def test_provider_collate_and_dropouts():
    cond = pcond.JointEmbeddingConditioner(dim=4, output_dim=8, device="cpu")
    provider = pcond.ConditioningProvider({"description": cond})
    jprovider = jcond.ConditioningProvider(
        {"description": jcond.JointEmbeddingConditioner(output_dim=8)})
    wav = np.random.RandomState(2).randn(1, 2, 30).astype(np.float32)
    attrs = [pcond.ConditioningAttributes(text={"description": "x"}),
             pcond.ConditioningAttributes(text={"description": "y"})]
    attrs[0].joint_embed["description"] = pcond.JointEmbedCondition(
        torch.from_numpy(wav), ["x"], torch.tensor([30]), [16000], [None],
        [None])
    jattrs = [jcond.ConditioningAttributes(text={"description": "x"}),
              jcond.ConditioningAttributes(text={"description": "y"})]
    jattrs[0].joint_embed["description"] = jcond.JointEmbedCondition(
        wav, ["x"], np.array([30]), [16000], [None], [None])
    got = provider._collate_joint_embeds(attrs)["description"]
    want = jprovider._collate_joint_embeds(jattrs)["description"]
    np.testing.assert_allclose(got.wav.numpy(), want.wav, atol=1e-7)
    assert got.text == want.text == ["x", None]
    assert got.sample_rate == want.sample_rate == [16000, 0]
    np.testing.assert_array_equal(got.length.numpy(), want.length)
    # CFG's default dropout keeps joint conditions; with the joint type
    # (or an attribute dropout of it) they become the null condition
    attrs, jattrs = attrs[:1], jattrs[:1]
    kept = pcond.ClassifierFreeGuidanceDropout(p=1.0)(attrs)
    assert kept[0].joint_embed["description"].text == ["x"]
    for dropped, jdropped in (
            (pcond.ClassifierFreeGuidanceDropout(p=1.0)(
                attrs, cond_types=("joint_embed",)),
             jcond.ClassifierFreeGuidanceDropout(p=1.0)(
                 jattrs, cond_types=["joint_embed"])),
            (pcond.AttributeDropout({"joint_embed": {"description": 1.0}},
                                    active_on_eval=True)(attrs),
             jcond.AttributeDropout({"joint_embed": {"description": 1.0}},
                                    active_on_eval=True)(jattrs))):
        n, jn = (dropped[0].joint_embed["description"],
                 jdropped[0].joint_embed["description"])
        assert n.wav.shape == jn.wav.shape == (1, 2, 1)
        assert n.text == jn.text == [None] and list(n.seek_time) == [0]
        assert int(n.length[0]) == int(jn.length[0]) == 0
    assert attrs[0].joint_embed["description"].text == ["x"]


def test_builder_from_clapemb2music(ckpt):
    _, d = ckpt
    cfg = load_config("conditioner/clapemb2music")
    cfg["conditioners"]["description"]["clap"]["checkpoint"] = str(
        d / "clap.safetensors")
    conds = builders.get_conditioners(16, cfg, device="cpu")
    cond = conds["description"]
    assert isinstance(cond, pcond.CLAPEmbeddingConditioner)
    assert cond.quantize
    assert len(cond.quantizer.vq.layers) == 12 and cond.quantizer.bins == 1024
    assert builders.get_condition_fuser(cfg).cond2fuse == {
        "description": "cross"}


# ---------------------------------------------------------------------- LM
def test_lm_greedy_tokens_with_clap_match_jax(ckpt):
    _, d = ckpt
    port_cond, jax_cond = _conditioners(d / "clap.safetensors", n_q=2, bins=16)
    fuse = {"cross": ["description"], "prepend": [], "sum": []}
    kw = dict(n_q=2, card=32, dim=16, num_heads=2, num_layers=1, causal=True,
              cross_attention=True, norm_first=True, cfg_coef=3.0)
    jmodel = jlm.LMModel(pattern_provider=JDelayedPatternProvider(n_q=2),
                         conditioners={"description": jax_cond},
                         fuser=jcond.ConditionFuser(fuse), **kw)
    params = jlm.init_lm_params(jmodel, jax.random.PRNGKey(0), seq_len=4)
    port = LMModel(DelayedPatternProvider(2), {"description": port_cond},
                   pcond.ConditionFuser(fuse), device="cpu", **kw)
    jax_weights.load_lm(port, jax.tree.map(np.asarray, params))
    texts = ["warm piano", "fast drums"]
    for with_joint in (True, False):
        attrs = [pcond.ConditioningAttributes(text={"description": t})
                 for t in texts]
        jattrs = [jcond.ConditioningAttributes(text={"description": t})
                  for t in texts]
        if with_joint:
            for a, ja, t in zip(attrs, jattrs, texts):
                a.joint_embed["description"] = pcond.JointEmbedCondition(
                    torch.zeros(1, 1, 1), [t], torch.tensor([1]), [48000],
                    [None], [None])
                ja.joint_embed["description"] = jcond.JointEmbedCondition(
                    np.zeros((1, 1, 1), np.float32), [t], np.array([1]),
                    [48000], [None], [None])
        want = np.asarray(jlm.generate(
            jmodel, params, jax.random.PRNGKey(0), conditions=jattrs,
            max_gen_len=8, gen=jlm.GenParams(use_sampling=False)))
        got = port.generate(conditions=attrs, max_gen_len=8,
                            gen=GenParams(use_sampling=False), device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        tok = port.condition_provider.tokenize(attrs)["description"]
        assert tok["valid"][:, 0].tolist() == ([1, 1] if with_joint
                                               else [0, 0])
