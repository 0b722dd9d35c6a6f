"""The port's DAC (`models/dac.py`) against the JAX package's on the CPU:
one descript-audio-codec `weights.pth` ({'state_dict', 'metadata':
{'kwargs'}}) written from the port's seeded model at a small geometry
(encoder 4 wide, strides 2-4, decoder 32, rates 4-2, 3 codebooks of
16 x 4) is read by both packages (`DAC.get_pretrained` and the JAX
`torch_port.load_dac_from_path`): codes equal and the decode within
atol 1e-5 (f32 convolutions), at every codebook and after
`set_num_codebooks(2)`; `jax_weights.load_dac` carries the JAX parameters
back; a raw state dict loads at the default 44.1 kHz geometry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import dac
from audiocraft_tpu_torch.utils import jax_weights
from tests.test_torch_mbd import _one_torch_thread  # noqa: F401

KW = dict(encoder_dim=4, encoder_rates=[2, 4], decoder_dim=32,
          decoder_rates=[4, 2], n_codebooks=3, codebook_size=16,
          codebook_dim=4, sample_rate=16000)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    torch.manual_seed(0)
    model = dac.DACModel(**KW)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():   # Snake alphas and gains off their init values
        for name, p in model.named_parameters():
            if name.endswith(("alpha", "weight_g")):
                p.mul_(1 + 0.3 * torch.rand(p.shape, generator=g))
    path = tmp_path_factory.mktemp("dac") / "weights.pth"
    torch.save({"state_dict": model.state_dict(),
                "metadata": {"kwargs": KW}}, path)
    port = dac.DAC.get_pretrained(path, device="cpu")
    jmodel, jvars = torch_port.load_dac_from_path(path)
    return model, port, jmodel, jvars


def _audio(seed, T=190):
    return (0.3 * np.random.RandomState(seed).randn(2, 1, T)).astype(
        np.float32)


@pytest.mark.parametrize("n_q", [3, 2])
def test_codes_and_decode_match_jax(pair, n_q):
    model, port, jmodel, jvars = pair
    for k, v in model.state_dict().items():
        assert torch.equal(port.model.state_dict()[k], v), k
    port.set_num_codebooks(n_q)
    jmodel.set_num_codebooks(n_q)
    x = _audio(n_q)
    jcodes, _ = jmodel.encode(jvars, jnp.asarray(x))
    codes, scale = port.encode(torch.from_numpy(x))
    assert scale is None and codes.shape == (2, n_q, 24)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = np.asarray(jmodel.decode(jvars, jcodes))
    got = port.decode(codes).numpy()
    assert got.shape == (2, 1, 192)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert port.num_codebooks == n_q and port.total_codebooks == 3
    assert port.frame_rate == 2000 and port.cardinality == 16
    with pytest.raises(AssertionError):
        port.set_num_codebooks(4)


def test_jax_params_round_trip(pair):
    model, _, _, jvars = pair
    fresh = dac.DACModel(**KW)
    jax_weights.load_dac(fresh, jax.tree.map(np.asarray, jvars))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)


def test_raw_state_dict_at_default_geometry(tmp_path):
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in dac.DACModel().state_dict().items()}
    state = {k: torch.full(s, 0.5) for k, s in shapes.items()}
    torch.save(state, tmp_path / "raw.pth")
    codec = dac.DAC.get_pretrained(tmp_path / "raw.pth", device="cpu")
    assert codec.sample_rate == 44100 and codec.frame_rate == 86
    assert codec.total_codebooks == 9 and codec.model.hop_length == 512
    assert len(shapes) == len(codec.model.state_dict())
