"""Residual vector quantization (counterpart of
`audiocraft_tpu/quantization/core_vq.py`): nearest-code search, residual
encode and decode, and the training forward (`rvq_forward`) with its EMA
codebook update (`ema_codebook_update`), which starts a codebook that is
not `inited` by k-means on its first batch (`kmeans`).

Codebook state lives in buffers named as upstream audiocraft's EMA codebooks
(`layers.{q}._codebook.embed`, `embed_avg`, `cluster_size`, `inited`); a
training forward updates them in place, under `torch.no_grad`. As in the
JAX package, a level quantizes its batch with the codebook it had before
the update, so the first training batch of a k-means codebook quantizes
against zeros; and k-means runs 10 iterations whatever the config's
`kmeans_iters` says (ROADMAP §3).
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
def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           generator: tp.Optional[torch.Generator] = None,
           means: tp.Optional[torch.Tensor] = None
           ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain k-means on samples [N, D] from `means` [C, D] (else
    `sample_vectors` from `generator`): each iteration assigns every sample
    to its nearest mean and moves each mean to its cluster's centroid (a
    mean without samples stays). Returns (means, cluster sizes [C]) of the
    final assignment."""
    if means is None:
        means = sample_vectors(samples, num_clusters, generator)
    for _ in range(num_iters):
        onehot = torch.nn.functional.one_hot(
            quantize_codes(means, samples), num_clusters).to(samples.dtype)
        bins = onehot.sum(0)
        new_means = (onehot.t() @ samples) / bins.clamp_min(1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = torch.nn.functional.one_hot(quantize_codes(means, samples),
                                       num_clusters).to(samples.dtype).sum(0)
    return means, bins


@torch.no_grad()
def ema_codebook_update(codebook: "EuclideanCodebook", flat: torch.Tensor, *,
                        decay: float, epsilon: float,
                        threshold_ema_dead_code: float,
                        generator: tp.Optional[torch.Generator] = None,
                        replacement: tp.Optional[torch.Tensor] = None,
                        init_means: tp.Optional[torch.Tensor] = None,
                        mesh=None) -> None:
    """One training update of `codebook` by the vectors flat [N, D], in
    place. A codebook that is not `inited` first takes k-means of the batch
    (from `init_means` [C, D], else from `sample_vectors` of `generator`)
    as its codes, embedding sums and cluster sizes. Then codes whose
    `cluster_size` fell below `threshold_ema_dead_code` (0: none) are
    expired and take rows of the batch (`replacement` [C, D], else
    `sample_vectors` from `generator`); every other code takes the EMA of
    its cluster's size (decay) and sum, normalised with Laplace smoothing
    (epsilon). Assignments use the codebook as it was before the EMA
    update (after the k-means). The count of expired codes is left in
    `codebook.last_expired`. With a `mesh` (`parallel/mesh.py`) flat is
    this rank's slice of the batch's vectors: the update takes the whole
    batch's, gathered in order, so every data rank keeps the codebook that
    one process would (the JAX package's step sees the global batch under
    GSPMD)."""
    flat = flat.float()
    if mesh is not None:
        from ..parallel.mesh import data_all_gather
        flat = data_all_gather(flat, mesh)
    size = codebook.embed.shape[0]
    if not bool(codebook.inited.all()):
        means, bins = kmeans(flat, size, generator=generator,
                             means=init_means)
        codebook.embed.copy_(means)
        codebook.embed_avg.copy_(means)
        codebook.cluster_size.copy_(bins)
        codebook.inited.fill_(1)
    onehot = torch.nn.functional.one_hot(quantize_codes(codebook.embed, flat),
                                         size).float()             # [N, C]
    expired = None
    if threshold_ema_dead_code > 0:
        expired = codebook.cluster_size < threshold_ema_dead_code
        if replacement is None:
            replacement = sample_vectors(flat, size, generator)
    # how many codes this update replaced (a 0-d tensor; not state)
    codebook.last_expired = (expired.sum() if expired is not None
                             else torch.zeros((), dtype=torch.long,
                                              device=flat.device))
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
    """One level's codebook buffers. With `kmeans_init` the codebook starts
    at zeros and not `inited` (k-means fills it on its first training
    batch); without, `inited` (the model's `reset_parameters` draws it)."""

    def __init__(self, dim: int, codebook_size: int, device=None,
                 kmeans_init: bool = False):
        super().__init__()
        self.register_buffer("inited", torch.full(
            (1,), 0.0 if kmeans_init else 1.0, device=device))
        self.register_buffer("cluster_size",
                             torch.zeros(codebook_size, device=device))
        self.register_buffer("embed", torch.zeros(codebook_size, dim,
                                                  device=device))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim,
                                                      device=device))


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None,
                 kmeans_init: bool = False):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size, device,
                                           kmeans_init)


class ResidualVectorQuantization(nn.Module):
    """Cascade of `num_quantizers` codebooks over residuals."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int,
                 device=None, kmeans_init: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            VectorQuantization(dim, codebook_size, device, kmeans_init)
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
                threshold_ema_dead_code: float = 2.0, mesh=None
                ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The residual cascade over x [B, T, D] through the first
        `n_q_active` levels (the others add nothing and stay as they are).
        Returns (quantized [B, T, D], codes [B, K, T] of every level, the
        commitment losses [K]: mean |quantized - residual|^2 of each active
        level, 0 for the others). With `training`, each active level's
        codebook takes an EMA step on its residuals (the batch's over the
        data ranks of `mesh`), and the output passes the gradient straight
        through to x."""
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
                    generator=generator, mesh=mesh)
            residual = residual - quantized
            quantized_out = quantized_out + quantized
        if training:
            quantized_out = x + (quantized_out - x).detach()
        return quantized_out, torch.stack(codes, dim=1), torch.stack(commits)
