"""Conditional flow matching over codec latents, JASCO's core (counterpart
of `audiocraft_tpu/models/flow_matching.py`).

`FlowMatchingModel` keeps upstream's names (`emb`, `transformer` with its
`skip_projections`, `out_norm`, `linear`, `temb.dense.{0,1}`, `temb_proj`,
`condition_provider.conditioners.*`). `generate` integrates the vector field
from Gaussian noise at t = 0 to t = 1 - 1e-5 under multi-source CFG: Euler
steps, or the adaptive Dormand-Prince solver of `jax.experimental.ode.
odeint` written out in PyTorch (`odeint_dopri5`): the same initial step,
error ratio, step-size controller and interpolation, its scalars in f32 on
the host, so each accept-or-reject decision reads one device scalar. The
initial noise comes from this module's `randn`, which a test can replace.
"""
import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from ..modules.conditioners import (AttributeDropout, BaseConditioner,
                                    ClassifierFreeGuidanceDropout,
                                    ConditionFuser, ConditioningAttributes,
                                    ConditioningProvider, ConditionType)
from ..modules.unet_transformer import UnetTransformer
from ..utils.utils import randn

ConditionTensors = tp.Dict[str, ConditionType]
JASCO_TEMPORAL_CONDS = ["chords", "self_wav", "melody"]  # order matters


class CFGTerm:
    """A term of multi-source classifier-free guidance: conditions and
    their weight."""

    def __init__(self, conditions: tp.List[ConditioningAttributes],
                 weight: float):
        self.conditions = conditions
        self.weight = weight


class AllCFGTerm(CFGTerm):
    """Keeps every condition."""


class NullCFGTerm(CFGTerm):
    """Drops every condition: texts, waveforms and symbolic ones."""

    def __init__(self, conditions, weight):
        super().__init__(ClassifierFreeGuidanceDropout(p=1.0)(
            conditions, cond_types=("wav", "text", "symbolic")), weight)


class TextCFGTerm(CFGTerm):
    """Keeps the text and drops the symbolic and waveform conditions that
    `model_att_dropout` lists."""

    def __init__(self, conditions, weight,
                 model_att_dropout: AttributeDropout):
        p = model_att_dropout.p
        dropper = AttributeDropout(
            {"symbolic": {k: 1.0 for k in p.get("symbolic", {})},
             "wav": {k: 1.0 for k in p.get("wav", {})}}, active_on_eval=True)
        super().__init__(dropper(conditions), weight)


class FlowMatchingModel(nn.Module):
    """latents [B, T, flow_dim], t [B] (or a scalar) and the condition
    tensors -> the vector field [B, T, flow_dim]. The temporal conditions
    are concatenated to the latents on features (in `JASCO_TEMPORAL_CONDS`
    order), embedded to `dim`, fused; the time's DDPM embedding, through a
    swish MLP and `temb_proj`, is added to the cross-attention source."""

    def __init__(self, conditioners: tp.Dict[str, BaseConditioner],
                 fuser: ConditionFuser, dim: int = 128, num_heads: int = 8,
                 flow_dim: int = 128, chords_dim: int = 0, drums_dim: int = 0,
                 melody_dim: int = 0, hidden_scale: int = 4,
                 norm_first: bool = False, bias_proj: bool = True,
                 cfg_coef: float = 1.0, time_embedding_dim: int = 128,
                 num_layers: int = 8, skip_connections: bool = True,
                 causal: bool = False, cross_attention: bool = True,
                 activation: str = "gelu", device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.condition_provider = ConditioningProvider(conditioners)
        self.fuser = fuser
        self.dim = dim
        self.flow_dim = flow_dim
        self.cfg_coef = cfg_coef
        self.time_embedding_dim = time_embedding_dim
        self.emb = nn.Linear(flow_dim + chords_dim + drums_dim + melody_dim,
                             dim, bias=False, **factory)
        self.transformer = UnetTransformer(
            d_model=dim, num_heads=num_heads, num_layers=num_layers,
            dim_feedforward=int(hidden_scale * dim), norm_first=norm_first,
            causal=causal, cross_attention=cross_attention,
            skip_connections=skip_connections, activation=activation,
            **factory)
        self.out_norm = (nn.LayerNorm(dim, eps=1e-5, **factory)
                         if norm_first else None)
        self.linear = nn.Linear(dim, flow_dim, bias=bias_proj, **factory)
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([
            nn.Linear(time_embedding_dim, 4 * time_embedding_dim, **factory),
            nn.Linear(4 * time_embedding_dim, 4 * time_embedding_dim,
                      **factory)])
        self.temb_proj = nn.Linear(4 * time_embedding_dim, dim, **factory)

    @property
    def conditioners(self) -> nn.ModuleDict:
        return self.condition_provider.conditioners

    def _get_timestep_embedding(self, timesteps: torch.Tensor,
                                embedding_dim: int) -> torch.Tensor:
        """The DDPM sinusoidal embedding of [B] times."""
        half_dim = embedding_dim // 2
        scale = math.log(10000) / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                       device=timesteps.device) * -scale)
        emb = timesteps.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
        if embedding_dim % 2 == 1:
            emb = torch.nn.functional.pad(emb, (0, 1))
        return emb

    def _embed_time_parameter(self, t: torch.Tensor) -> torch.Tensor:
        temb = self.temb.dense[0](self._get_timestep_embedding(
            t.reshape(-1), self.time_embedding_dim).to(self.emb.weight.dtype))
        return self.temb.dense[1](temb * torch.sigmoid(temb))

    def compute_conditions(self, tokenized: tp.Dict[str, tp.Any]
                           ) -> ConditionTensors:
        return self.condition_provider(tokenized)

    @staticmethod
    def _align_seq_length(cond: torch.Tensor, seq_len: int) -> torch.Tensor:
        """Cut or zero-pad a temporal condition [B, T', C] to seq_len."""
        cond = cond[:, :seq_len]
        return torch.nn.functional.pad(cond, (0, 0, 0, seq_len - cond.shape[1]))

    def forward(self, latents: torch.Tensor,
                t: tp.Union[float, torch.Tensor],
                condition_tensors: ConditionTensors) -> torch.Tensor:
        B, T, _ = latents.shape
        dtype = self.emb.weight.dtype
        x = latents.to(dtype)
        for cond in JASCO_TEMPORAL_CONDS:
            if cond in condition_tensors:
                x = torch.cat([x, self._align_seq_length(
                    condition_tensors[cond][0].to(dtype), T)], dim=-1)
        input_, cross_attention_input = self.fuser(self.emb(x),
                                                   condition_tensors)
        t = torch.as_tensor(t, dtype=torch.float32, device=latents.device)
        if t.dim() == 0:
            t = t.expand(B)
        cross_attention_input = (cross_attention_input + self.temb_proj(
            self._embed_time_parameter(t))[:, None, :])
        out = self.transformer(input_,
                               cross_attention_src=cross_attention_input)
        if self.out_norm is not None:
            out = self.out_norm(out)
        v_theta = self.linear(out)
        if self.fuser.fuse2cond.get("prepend"):
            v_theta = v_theta[:, -T:]
        return v_theta


# --------------------------------------------------------------- generation

def multi_source_cfg_preprocess(
        model: FlowMatchingModel, tokenize_fn,
        conditions: tp.List[ConditioningAttributes], cfg_coef_all: float,
        cfg_coef_txt: float, att_dropout: tp.Optional[AttributeDropout] = None,
        min_weight: float = 1e-6
) -> tp.Tuple[ConditionTensors, tp.List[CFGTerm]]:
    """The CFG terms (all conditions with `cfg_coef_all`, text only with
    `cfg_coef_txt`, none with the rest of 1), those under `min_weight`
    dropped, and the condition tensors of their rows stacked in order."""
    cfg_terms: tp.List[CFGTerm] = []
    condition_tensors: ConditionTensors = {}
    if conditions:
        cfg_terms = [AllCFGTerm(conditions, cfg_coef_all),
                     TextCFGTerm(conditions, cfg_coef_txt,
                                 att_dropout or AttributeDropout({}))]
        cfg_terms.append(NullCFGTerm(
            conditions, 1 - sum(ct.weight for ct in cfg_terms)))
        cfg_terms = [ct for ct in cfg_terms if abs(ct.weight) >= min_weight]
        conds = sum([ct.conditions for ct in cfg_terms], [])
        condition_tensors = model.compute_conditions(tokenize_fn(conds))
    return condition_tensors, cfg_terms


# Dormand-Prince tableau and interpolation (`jax.experimental.ode`)
_ALPHA = np.array([1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0], np.float32)
_BETA = np.array([
    [1 / 5, 0, 0, 0, 0, 0, 0], [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]],
    np.float32)
_C_SOL = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0], np.float32)
_C_ERROR = np.array([
    35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
    125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
    11 / 84 - 649 / 6300, -1. / 60.], np.float32)
_DPS_C_MID = np.array([
    6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
    -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
    -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2], np.float32)
_F32 = np.float32


def _dot(coefs: np.ndarray, ks: tp.List[torch.Tensor]) -> torch.Tensor:
    """sum_j coefs[j] * ks[j] over the stages with a coefficient."""
    terms = [float(c) * k for c, k in zip(coefs, ks) if c != 0]
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def _norm(x: torch.Tensor) -> np.float32:
    return _F32(torch.linalg.vector_norm(x).item())


def _initial_step_size(fun, t0, y0, order, rtol, atol, f0) -> np.float32:
    """Hairer, Norsett and Wanner, Solving ODEs I, Sec. II.4."""
    scale = atol + y0.abs() * rtol
    d0, d1 = _norm(y0 / scale), _norm(f0 / scale)
    h0 = _F32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else _F32(0.01) * d0 / d1
    f1 = fun(y0 + float(h0) * f0, _F32(t0 + h0))
    d2 = _norm((f1 - f0) / scale) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = np.maximum(_F32(1e-6), h0 * _F32(1e-3))
    else:
        h1 = (_F32(0.01) / np.maximum(d1, d2)) ** _F32(1. / (order + 1.))
    return np.minimum(_F32(100.) * h0, h1)


def _optimal_step_size(last_step, ratio, safety=0.9, ifactor=10.0,
                       dfactor=0.2, order=5.0) -> np.float32:
    dfactor = _F32(1.0) if ratio < 1 else _F32(dfactor)
    factor = np.minimum(_F32(ifactor), np.maximum(
        ratio ** _F32(-1.0 / order) * _F32(safety), dfactor))
    return last_step * _F32(ifactor) if ratio == 0 else last_step * factor


def odeint_dopri5(func, y0: torch.Tensor, t0: float, t1: float,
                  rtol: float = 1e-5, atol: float = 1e-5) -> torch.Tensor:
    """y(t1) for dy/dt = func(y, t) from y(t0) = y0 with the adaptive
    Dormand-Prince method of `jax.experimental.ode.odeint`: steps go past
    t1 and the last one's quartic interpolant gives y(t1). `func` takes t
    as an f32 numpy scalar."""
    t0, target = _F32(t0), _F32(t1)
    f0 = func(y0, t0)
    dt = np.clip(_initial_step_size(func, t0, y0, 4, rtol, atol, f0), 0,
                 np.inf)
    y, f, t, last_t = y0, f0, t0, t0
    interp = [y0] * 5
    while t < target and dt > 0:
        ks = [f]
        for i in range(1, 7):
            ks.append(func(y + float(dt) * _dot(_BETA[i - 1], ks),
                           _F32(t + dt * _ALPHA[i - 1])))
        next_y = y + float(dt) * _dot(_C_SOL, ks)
        error = float(dt) * _dot(_C_ERROR, ks)
        tol = atol + rtol * torch.maximum(y.abs(), next_y.abs())
        ratio = _F32((error / tol).square().mean().sqrt().item())
        if ratio <= 1:
            y_mid = y + float(dt) * _dot(_DPS_C_MID, ks)
            dy0, dy1 = float(dt) * ks[0], float(dt) * ks[-1]
            interp = [-2. * dy0 + 2. * dy1 - 8. * y - 8. * next_y + 16. * y_mid,
                      5. * dy0 - 3. * dy1 + 18. * y + 14. * next_y - 32. * y_mid,
                      -4. * dy0 + dy1 - 11. * y - 5. * next_y + 16. * y_mid,
                      dy0, y]
            y, f, last_t, t = next_y, ks[-1], t, _F32(t + dt)
        dt = np.clip(_optimal_step_size(dt, ratio), 0, np.inf)
    x = float(_F32((target - last_t) / (t - last_t)))
    out = torch.zeros_like(y0)
    for coef in interp:
        out = out * x + coef
    return out


@torch.no_grad()
def generate(model: FlowMatchingModel, tokenize_fn,
             conditions: tp.List[ConditioningAttributes] = [],
             num_samples: tp.Optional[int] = None, max_gen_len: int = 256,
             cfg_coef_all: float = 3.0, cfg_coef_txt: float = 1.0,
             euler: bool = False, euler_steps: int = 100,
             ode_rtol: float = 1e-5, ode_atol: float = 1e-5,
             att_dropout: tp.Optional[AttributeDropout] = None,
             generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
    """Latents [B, max_gen_len, flow_dim] from noise, on the model's
    device: `euler_steps` Euler steps, or Dormand-Prince to 1 - 1e-5."""
    if num_samples is None:
        num_samples = len(conditions) if conditions else 1
    device = model.emb.weight.device
    condition_tensors, cfg_terms = multi_source_cfg_preprocess(
        model, tokenize_fn, conditions, cfg_coef_all, cfg_coef_txt,
        att_dropout)
    n_terms = max(len(cfg_terms), 1)
    weights = torch.tensor([ct.weight for ct in cfg_terms],
                           dtype=torch.float32, device=device)
    z_0 = randn((num_samples, max_gen_len, model.flow_dim), generator, device)

    def vector_field(z: torch.Tensor, t) -> torch.Tensor:
        v = model(z.repeat(n_terms, 1, 1) if n_terms > 1 else z,
                  torch.full((n_terms * z.shape[0],), float(t), device=device),
                  condition_tensors).float()
        if n_terms > 1:
            v = (weights[:, None, None, None]
                 * v.reshape(n_terms, *z.shape)).sum(dim=0)
        return v

    if euler:
        dt = 1.0 / euler_steps
        z = z_0
        for i in range(euler_steps):
            z = z + dt * vector_field(z, _F32(i) * _F32(dt))
        return z
    return odeint_dopri5(vector_field, z_0, 0.0, 1.0 - 1e-5, rtol=ode_rtol,
                         atol=ode_atol)
