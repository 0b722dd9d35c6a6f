"""The port's discriminators and adversarial losses
(`audiocraft_tpu_torch/adversarial/`) against the JAX package on the CPU,
with the JAX init's weights carried by `jax_weights.load_adversary`:

- the MS-STFT, multi-period and multi-scale discriminators at 2-4 filters
  (weight-normed and plain layers): every logit and feature map, the JAX
  package's NHWC (or [B, T, C]) transposed to the port's NCHW ([B, C, T]);
- the three criteria (mse, hinge, hinge2): generator, real and fake, with
  their gradients;
- `AdversarialLoss.forward` (adversarial and feature-matching losses and
  their gradients with respect to the fake) and one `train_adv` step (the
  loss, every parameter after Adam).

Tolerances: logits and feature maps atol 1e-5 / rtol 1e-4 (f32
convolutions over an f32 STFT); criteria rtol 1e-6 and gradients atol
1e-9; the generator losses rtol 1e-5, their gradients within 1e-4 of the
largest entry; the discriminator loss rtol 1e-5 and each parameter after
Adam within 2 x lr of JAX's (one Adam step moves a parameter by about
lr x sign(g), which f32 rounding of a near-zero g may flip).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiocraft_tpu import adversarial as jadv
from audiocraft_tpu_torch import adversarial as tadv
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

LR = 3e-4
SMALL = {
    "msstftd": dict(filters=2, n_ffts=(128, 64), hop_lengths=(32, 16),
                    win_lengths=(128, 64)),
    "mpd": dict(filters=2, periods=(2, 3)),
    "msd": dict(filters=4, scale_norms=("weight_norm", "none")),
}
CLASSES = {"msstftd": (jadv.MultiScaleSTFTDiscriminator,
                       tadv.MultiScaleSTFTDiscriminator),
           "mpd": (jadv.MultiPeriodDiscriminator,
                   tadv.MultiPeriodDiscriminator),
           "msd": (jadv.MultiScaleDiscriminator,
                   tadv.MultiScaleDiscriminator)}


def _audio(seed, shape=(2, 1, 801)):
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(a) -> np.ndarray:
    """A JAX feature map in the port's layout."""
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a.transpose(0, 2, 1)


def _pair(name, x):
    jcls, tcls = CLASSES[name]
    jmod = jcls(**SMALL[name])
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    # move each weight norm's g away from ||v||, so that g counts
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * np.linspace(0.5, 1.5, a.size, dtype=np.float32
                                        ).reshape(a.shape)
        if str(path[-1]).endswith("kernel_g']") else a, params)
    port = tcls(**SMALL[name])
    jax_weights.load_adversary(port, _np(params))
    return jmod, params, port


@pytest.mark.parametrize("name", ["msstftd", "mpd", "msd"])
def test_discriminator_matches_jax(name):
    x = _audio(0)
    jmod, params, port = _pair(name, x)
    want_logits, want_fmaps = jax.jit(jmod.apply)(params, jnp.asarray(x))
    got_logits, got_fmaps = port(torch.from_numpy(x))
    assert len(got_logits) == len(want_logits) == port.num_discriminators
    for got, want in zip(got_logits, want_logits):
        np.testing.assert_allclose(got.detach().numpy(), _nchw(want),
                                   atol=1e-5, rtol=1e-4)
    for got_maps, want_maps in zip(got_fmaps, want_fmaps):
        assert len(got_maps) == len(want_maps)
        for got, want in zip(got_maps, want_maps):
            np.testing.assert_allclose(got.detach().numpy(), _nchw(want),
                                       atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("loss_type", ["mse", "hinge", "hinge2"])
def test_criteria_match_jax(loss_type):
    logits = np.random.RandomState(1).randn(3, 1, 7, 5).astype(np.float32) * 2
    for getter in ("get_adv_criterion", "get_real_criterion",
                   "get_fake_criterion"):
        jfn = getattr(jadv, getter)(loss_type)
        tfn = getattr(tadv, getter)(loss_type)
        want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
        t = torch.from_numpy(logits).requires_grad_(True)
        got = tfn(t)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   err_msg=getter)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                                   atol=1e-9, err_msg=getter)


def _adversarial_pair(name, x):
    jmod, params, port = _pair(name, x)
    kw = dict(loss=jadv.get_adv_criterion("hinge"),
              loss_real=jadv.get_real_criterion("hinge"),
              loss_fake=jadv.get_fake_criterion("hinge"),
              loss_feat=jadv.FeatureMatchingLoss())
    jloss = jadv.AdversarialLoss(jmod, optax.adam(LR, b1=0.5, b2=0.9), **kw)
    tloss = tadv.AdversarialLoss(
        port, torch.optim.Adam(port.parameters(), lr=LR, betas=(0.5, 0.9)),
        loss=tadv.get_adv_criterion("hinge"),
        loss_real=tadv.get_real_criterion("hinge"),
        loss_fake=tadv.get_fake_criterion("hinge"),
        loss_feat=tadv.FeatureMatchingLoss())
    return jloss, params, tloss


@pytest.mark.parametrize("name", ["msstftd", "mpd"])
def test_generator_losses_match_jax(name):
    fake, real = _audio(2), _audio(3)
    jloss, params, tloss = _adversarial_pair(name, fake)
    wants = jax.jit(lambda p, f, r: [jax.value_and_grad(
        lambda a, i=i: jloss.forward(p, a, r)[i])(f) for i in range(2)])(
            params, jnp.asarray(fake), jnp.asarray(real))
    # the adversarial loss, then feature matching
    for i, (want, want_grad) in enumerate(wants):
        f = torch.from_numpy(fake).requires_grad_(True)
        got = tloss(f, torch.from_numpy(real))[i]
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        want_grad = np.asarray(want_grad)
        np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0,
                                   atol=1e-4 * np.abs(want_grad).max())


def test_train_adv_step_matches_jax():
    fake, real = _audio(4), _audio(5)
    jloss, params, tloss = _adversarial_pair("msstftd", fake)
    state = jadv.AdversaryState(params=params,
                                opt_state=jloss.optimizer.init(params))
    new_state, want = jax.jit(jloss.train_adv)(state, jnp.asarray(fake),
                                               jnp.asarray(real))
    got = tloss.train_adv(torch.from_numpy(fake), torch.from_numpy(real))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    expected = jax_weights.adversary_state(tloss.adversary,
                                           _np(new_state.params))
    before = jax_weights.adversary_state(tloss.adversary, _np(params))
    moved = []
    for key, value in tloss.adversary.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key], rtol=0,
                                   atol=2 * LR, err_msg=key)
        if np.abs(value.numpy() - before[key]).max() > LR / 2:
            moved.append(key)
    assert "discriminators.0.conv_post.conv.weight_v" in moved
