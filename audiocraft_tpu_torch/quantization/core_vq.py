"""Residual vector quantization (counterpart of
`audiocraft_tpu/quantization/core_vq.py`): nearest-code search, residual
encode and decode, and the training forward (`rvq_forward`) with its EMA
codebook update (`ema_codebook_update`).

Codebook state lives in buffers named as upstream audiocraft's EMA codebooks
(`layers.{q}._codebook.embed`, `embed_avg`, `cluster_size`, `inited`); a
training forward updates them in place, under `torch.no_grad`. The k-means
initialisation of a codebook that is not `inited` is not ported (ROADMAP,
slice F: the codec's training needs it); such a codebook raises.
"""
import typing as tp

import torch
import torch.nn as nn


def quantize_codes(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest code indices for x [..., D] against embed [C, D]; the |x|^2
    term is constant in the argmin and dropped."""
    flat = x.reshape(-1, x.shape[-1])
    dists = flat @ embed.t().to(flat.dtype) * 2 - embed.square().sum(-1).to(flat.dtype)
    return dists.argmax(dim=-1).reshape(x.shape[:-1])


def rvq_decode(embeds: tp.Sequence[torch.Tensor], codes: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """codes [B, K, T] -> sum over levels of embeds[k][codes[:, k]], [B, T, D]."""
    B, K, T = codes.shape
    out = torch.zeros(B, T, embeds[0].shape[-1], dtype=dtype,
                      device=codes.device)
    for k in range(K):
        out = out + embeds[k].to(dtype)[codes[:, k]]
    return out


def sample_vectors(samples: torch.Tensor, num: int,
                   generator: tp.Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """`num` rows of samples [N, D]: a random subset when N >= num, else
    drawn with replacement. The indices come from `generator` (on the
    CPU)."""
    n = samples.shape[0]
    if n >= num:
        idx = torch.randperm(n, generator=generator)[:num]
    else:
        idx = torch.randint(0, n, (num,), generator=generator)
    return samples[idx.to(samples.device)]


@torch.no_grad()
def ema_codebook_update(codebook: "EuclideanCodebook", flat: torch.Tensor, *,
                        decay: float, epsilon: float,
                        threshold_ema_dead_code: float,
                        generator: tp.Optional[torch.Generator] = None,
                        replacement: tp.Optional[torch.Tensor] = None) -> None:
    """One training update of `codebook` by the vectors flat [N, D], in
    place: codes whose `cluster_size` fell below `threshold_ema_dead_code`
    (0: none) are expired and take rows of the batch (`replacement` [C, D],
    else `sample_vectors` from `generator`); every other code takes the EMA
    of its cluster's size (decay) and sum, normalised with Laplace smoothing
    (epsilon). Assignments use the codebook as it was before the update."""
    if not bool(codebook.inited.all()):
        raise NotImplementedError("k-means initialisation of a codebook is "
                                  "not ported (ROADMAP, slice F)")
    flat = flat.float()
    size = codebook.embed.shape[0]
    onehot = torch.nn.functional.one_hot(quantize_codes(codebook.embed, flat),
                                         size).float()             # [N, C]
    expired = None
    if threshold_ema_dead_code > 0:
        expired = codebook.cluster_size < threshold_ema_dead_code
        if replacement is None:
            replacement = sample_vectors(flat, size, generator)
    cluster_size = (codebook.cluster_size * decay
                    + onehot.sum(0) * (1 - decay))
    embed_avg = codebook.embed_avg * decay + (onehot.t() @ flat) * (1 - decay)
    total = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (total + size * epsilon) * total
    embed = embed_avg / smoothed[:, None]
    if expired is not None:
        rows = expired[:, None]
        embed = torch.where(rows, replacement, embed)
        embed_avg = torch.where(rows, replacement, embed_avg)
        cluster_size = torch.where(
            expired, torch.full_like(cluster_size, threshold_ema_dead_code),
            cluster_size)
    codebook.cluster_size.copy_(cluster_size)
    codebook.embed_avg.copy_(embed_avg)
    codebook.embed.copy_(embed)


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.register_buffer("inited", torch.ones(1, device=device))
        self.register_buffer("cluster_size",
                             torch.zeros(codebook_size, device=device))
        self.register_buffer("embed", torch.zeros(codebook_size, dim,
                                                  device=device))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim,
                                                      device=device))


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size, device)


class ResidualVectorQuantization(nn.Module):
    """Cascade of `num_quantizers` codebooks over residuals."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            VectorQuantization(dim, codebook_size, device)
            for _ in range(num_quantizers)])

    def embeds(self, n_q: int) -> tp.List[torch.Tensor]:
        return [layer._codebook.embed for layer in self.layers[:n_q]]

    def encode(self, x: torch.Tensor, n_q: int) -> torch.Tensor:
        """x [B, T, D] -> codes [B, K, T]."""
        residual = x
        codes = []
        for embed in self.embeds(n_q):
            embed = embed.to(x.dtype)
            c = quantize_codes(embed, residual)
            residual = residual - embed[c]
            codes.append(c)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """codes [B, K, T] -> [B, T, D]."""
        return rvq_decode(self.embeds(codes.shape[1]), codes, dtype)

    def forward(self, x: torch.Tensor, n_q_active: int, training: bool,
                generator: tp.Optional[torch.Generator] = None,
                decay: float = 0.99, epsilon: float = 1e-5,
                threshold_ema_dead_code: float = 2.0
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The residual cascade over x [B, T, D] through the first
        `n_q_active` levels (the others add nothing and stay as they are).
        Returns (quantized [B, T, D], codes [B, K, T] of every level, the
        commitment losses [K]: mean |quantized - residual|^2 of each active
        level, 0 for the others). With `training`, each active level's
        codebook takes an EMA step on its residuals, and the output passes
        the gradient straight through to x."""
        residual = x
        quantized_out = torch.zeros_like(x)
        codes, commits = [], []
        for level, layer in enumerate(self.layers):
            embed = layer._codebook.embed.to(x.dtype)
            c = quantize_codes(embed, residual)
            quantized = embed[c].detach()
            codes.append(c)
            if level >= n_q_active:
                commits.append(torch.zeros((), device=x.device))
                continue
            commits.append(torch.mean(torch.square(quantized - residual)
                                      ).float())
            if training:
                ema_codebook_update(
                    layer._codebook, residual.detach().reshape(-1, x.shape[-1]),
                    decay=decay, epsilon=epsilon,
                    threshold_ema_dead_code=threshold_ema_dead_code,
                    generator=generator)
            residual = residual - quantized
            quantized_out = quantized_out + quantized
        if training:
            quantized_out = x + (quantized_out - x).detach()
        return quantized_out, torch.stack(codes, dim=1), torch.stack(commits)
