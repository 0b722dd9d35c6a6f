"""Gradient-norm loss balancer (counterpart of
`audiocraft_tpu/losses/balancer.py`).

Each loss's gradient with respect to the model's output is rescaled so
that it makes up its weight's share of `total_norm` in the summed
gradient. The state is a debiased EMA of each gradient's norm: with beta
= `ema_decay`, sum = beta * sum + norm, count = beta * count + 1, and the
average is sum / count (beta 1: the plain mean). The norm is the mean over
batch items of each item's norm with `per_batch_item`, else the whole
gradient's. Without `balance_grads` each gradient is scaled by its weight.

With a `mesh` (`parallel/mesh.py`), each data rank holds its slice of the
batch and the gradients of its own mean losses; the norms are taken of the
whole batch's gradient (each rank's is 1 / ranks of it), so every rank
scales as one process would.
"""
import typing as tp

import torch


class Balancer:
    def __init__(self, weights: tp.Dict[str, float], balance_grads: bool = True,
                 total_norm: float = 1., ema_decay: float = 0.999,
                 per_batch_item: bool = True, epsilon: float = 1e-12,
                 monitor: bool = False):
        self.weights = weights
        self.per_batch_item = per_batch_item
        self.total_norm = total_norm or 1.
        self.ema_decay = ema_decay or 1.
        self.epsilon = epsilon
        self.monitor = monitor
        self.balance_grads = balance_grads
        self.avg: tp.Dict[str, torch.Tensor] = {}
        self.count: tp.Optional[torch.Tensor] = None

    def _grad_norm(self, grad: torch.Tensor) -> torch.Tensor:
        if self.per_batch_item:
            dims = tuple(range(1, grad.dim()))
            return grad.square().sum(dims).sqrt().mean()
        return grad.square().sum().sqrt()

    def _global_norms(self, norms: tp.Dict[str, torch.Tensor], mesh
                      ) -> tp.Dict[str, torch.Tensor]:
        from ..parallel.mesh import data_all_reduce, data_size
        n = data_size(mesh)
        names = sorted(norms)
        stacked = torch.stack([norms[k] for k in names])
        if self.per_batch_item:  # the mean over every item of the batch
            stacked = data_all_reduce(stacked, mesh) / n
        else:
            stacked = data_all_reduce(stacked.square(), mesh).sqrt()
        return dict(zip(names, stacked / n))

    @torch.no_grad()
    def compute_out_grad(self, losses: tp.Dict[str, torch.Tensor],
                         grads: tp.Dict[str, torch.Tensor], mesh=None
                         ) -> tp.Tuple[torch.Tensor, torch.Tensor, dict]:
        """(out_grad, effective loss, metrics) from each loss and its
        gradient with respect to the output; the EMA state takes this
        step's norms. The effective loss is the sum of scale x loss, the
        losses detached."""
        assert set(losses) == set(self.weights), (losses.keys(),
                                                  self.weights.keys())
        norms = {name: self._grad_norm(g) for name, g in grads.items()}
        if mesh is not None:
            norms = self._global_norms(norms, mesh)
        beta = self.ema_decay
        if self.count is None:
            device = next(iter(norms.values())).device
            self.count = torch.zeros((), device=device)
            self.avg = {k: torch.zeros((), device=device)
                        for k in sorted(self.weights)}
        self.count = self.count * beta + 1
        for k in norms:
            self.avg[k] = self.avg[k] * beta + norms[k]
        avg_norms = {k: self.avg[k] / self.count for k in norms}

        metrics = {}
        if self.monitor:
            total = sum(avg_norms.values())
            for k, v in avg_norms.items():
                metrics[f"ratio_{k}"] = v / total
        total_weights = sum(self.weights[k] for k in avg_norms)
        assert total_weights > 0.
        out_grad = None
        effective_loss = torch.zeros((), device=self.count.device)
        for name, avg_norm in avg_norms.items():
            if self.balance_grads:
                ratio = self.weights[name] / total_weights
                scale = ratio * self.total_norm / (self.epsilon + avg_norm)
            else:
                scale = torch.tensor(float(self.weights[name]),
                                     device=avg_norm.device)
            g = grads[name] * scale
            out_grad = g if out_grad is None else out_grad + g
            effective_loss = effective_loss + scale * losses[name].detach()
        return out_grad, effective_loss, metrics

    def backward(self, losses: tp.Dict[str, torch.Tensor], input: torch.Tensor,
                 mesh=None) -> tp.Tuple[torch.Tensor, dict]:
        """Each loss's gradient with respect to `input`, balanced; the
        balanced gradient is back-propagated from `input` and the effective
        loss returned with the metrics."""
        grads = {}
        for name, loss in losses.items():
            if loss.requires_grad:  # else a constant: a zero gradient
                grads[name], = torch.autograd.grad(loss, [input],
                                                   retain_graph=True)
            else:
                grads[name] = torch.zeros_like(input)
        out_grad, effective_loss, metrics = self.compute_out_grad(
            losses, grads, mesh)
        input.backward(out_grad)
        return effective_loss, metrics

    def state_dict(self) -> dict:
        return {"avg": dict(self.avg), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.avg = dict(state["avg"])
        self.count = state["count"]
