"""The port's codec vs the JAX package in f32 on the CPU: weight-normed
convs, the LSTM, RVQ decode, the SEANet decoder, and `EncodecModel`
decode/encode at the debug size; the state-dict keys checked against
`audiocraft_tpu/utils/torch_port.py`.

JAX convs are channels-last ([B, T, C]); the port's are channels-first, so
module tests transpose explicitly. Tolerance: atol 1e-5 / rtol 1e-4 for
single modules, atol 1e-4 / rtol 1e-3 for whole SEANet stacks (f32, deep
conv stacks summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import builders as jbuilders
from audiocraft_tpu.modules import conv as jconv
from audiocraft_tpu.modules import lstm as jlstm
from audiocraft_tpu.modules import seanet as jseanet
from audiocraft_tpu.utils import torch_port
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.modules import conv as tconv
from audiocraft_tpu_torch.modules import lstm as tlstm
from audiocraft_tpu_torch.modules import seanet as tseanet
from audiocraft_tpu_torch.utils import jax_weights


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _btc(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("norm", ["none", "weight_norm"])
def test_streamable_conv_matches_jax(transposed, norm):
    x = _rand(0, 2, 23, 6)  # [B, T, C]
    if transposed:
        jmod = jconv.StreamableConvTranspose1d(6, 5, kernel_size=8, stride=4,
                                               norm=norm)
        port = tconv.StreamableConvTranspose1d(6, 5, kernel_size=8, stride=4,
                                               norm=norm)
        key, prefix = "convtr", "convtr.convtr."
    else:
        jmod = jconv.StreamableConv1d(6, 5, kernel_size=7, stride=2,
                                      dilation=1, norm=norm)
        port = tconv.StreamableConv1d(6, 5, kernel_size=7, stride=2, norm=norm)
        key, prefix = "conv", "conv.conv."
    params = jmod.init(jax.random.PRNGKey(0), x)
    p = _np(params)["params"][key]
    if norm == "weight_norm":  # move g away from ||v|| so the norm matters
        p = dict(p, kernel_g=p["kernel_g"] * np.linspace(0.5, 2, p["kernel_g"].size,
                                                         dtype=np.float32))
        params = {"params": {key: p}}
    expected = jmod.apply(params, x)
    state: dict = {}
    jax_weights._conv(p, prefix, transposed, state)
    jax_weights._load(port, state)
    got = port(torch.from_numpy(x.transpose(0, 2, 1)))
    np.testing.assert_allclose(_btc(got), np.asarray(expected), atol=1e-5,
                               rtol=1e-4)


def test_lstm_matches_jax():
    x = _rand(1, 2, 9, 8)
    jmod = jlstm.StreamableLSTM(8, num_layers=2)
    params = jmod.init(jax.random.PRNGKey(1), x)
    expected = jmod.apply(params, x)
    port = tlstm.StreamableLSTM(8, num_layers=2)
    state: dict = {}
    for n in range(2):
        lp = _np(params)["params"][f"lstm_{n}"]
        state[f"lstm.weight_ih_l{n}"] = lp["w_ih"].T
        state[f"lstm.weight_hh_l{n}"] = lp["w_hh"].T
        state[f"lstm.bias_ih_l{n}"] = lp["b_ih"]
        state[f"lstm.bias_hh_l{n}"] = lp["b_hh"]
    jax_weights._load(port, state)
    got = port(torch.from_numpy(x.transpose(0, 2, 1)))
    np.testing.assert_allclose(_btc(got), np.asarray(expected), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("norm", ["none", "weight_norm"])
def test_seanet_decoder_matches_jax(norm):
    """EnCodec-32kHz-shaped decoder at narrow width: LSTM bottleneck, 4
    upsampling stages, weight norm on or off."""
    kw = dict(channels=1, dimension=16, n_filters=4, n_residual_layers=1,
              ratios=(4, 2, 2, 2), lstm=2, norm=norm)
    z = _rand(2, 2, 6, 16)
    jdec = jseanet.SEANetDecoder(**kw)
    params = jdec.init(jax.random.PRNGKey(2), z)
    expected = jdec.apply(params, z)
    port = tseanet.SEANetDecoder(**kw)
    jax_weights.load_seanet(port, _np(params), decoder=True)
    got = port(torch.from_numpy(z.transpose(0, 2, 1)))
    np.testing.assert_allclose(_btc(got), np.asarray(expected), atol=1e-4,
                               rtol=1e-3)


def test_seanet_encoder_matches_jax():
    kw = dict(channels=1, dimension=16, n_filters=4, n_residual_layers=2,
              ratios=(4, 2), lstm=1, norm="weight_norm", true_skip=False)
    x = _rand(3, 2, 37, 1)
    jenc = jseanet.SEANetEncoder(**kw)
    params = jenc.init(jax.random.PRNGKey(3), x)
    expected = jenc.apply(params, x)
    port = tseanet.SEANetEncoder(**kw)
    jax_weights.load_seanet(port, _np(params), decoder=False)
    got = port(torch.from_numpy(x.transpose(0, 2, 1)))
    np.testing.assert_allclose(_btc(got), np.asarray(expected), atol=1e-4,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def debug_codec():
    jmodel, jvars = jbuilders.get_debug_compression_model()
    port = builders.get_debug_compression_model(device="cpu")
    jax_weights.load_encodec(port, _np(jvars))
    return jmodel, jvars, port


def test_rvq_decode_matches_jax(debug_codec):
    jmodel, jvars, port = debug_codec
    codes = np.random.RandomState(4).randint(0, 400, (2, 4, 7))
    expected = jmodel.quantizer.decode(jvars["quantizer"], jnp.asarray(codes))
    got = port.quantizer.decode(torch.from_numpy(codes))  # [B, D, T]
    np.testing.assert_allclose(_btc(got), np.asarray(expected), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(port.decode_latent(torch.from_numpy(codes)).numpy(),
                               np.asarray(expected), atol=1e-6, rtol=1e-6)


def test_encodec_decode_and_encode_match_jax(debug_codec):
    jmodel, jvars, port = debug_codec
    codes = np.random.RandomState(5).randint(0, 400, (2, 4, 6))
    expected = jmodel.decode(jvars, jnp.asarray(codes))
    got = port.decode(torch.from_numpy(codes), device="cpu")
    assert got.shape == expected.shape == (2, 1, 6 * 1280)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-4,
                               rtol=1e-3)
    wav = _rand(6, 1, 1, 3 * 1280) * 0.1
    jcodes, _ = jmodel.encode(jvars, jnp.asarray(wav))
    tcodes, scale = port.encode(torch.from_numpy(wav), device="cpu")
    assert scale is None
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))


def test_state_dict_keys_convert_back_to_jax_params(debug_codec):
    """port state_dict -> torch_port.convert_encodec_state (upstream keys)
    == the JAX variables the port was loaded from."""
    _, jvars, port = debug_codec
    src = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_port.convert_encodec_state(src, ratios=(10, 8, 16),
                                            n_residual_layers=1, lstm=0, n_q=4)
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 _np(jvars)["params"])
    for field in ("embed", "embed_avg", "cluster_size", "inited"):
        np.testing.assert_array_equal(
            np.asarray(getattr(back["quantizer"].codebooks, field)),
            np.asarray(getattr(jvars["quantizer"].codebooks, field)))
