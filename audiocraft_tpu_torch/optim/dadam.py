"""D-Adaptation Adam: Adam whose step size is estimated as it trains
(arXiv 2301.07733); counterpart of `audiocraft_tpu/optim/dadam.py`.

The state and the update are the JAX package's: per parameter the first
moment `exp_avg` (with the step size d * lr folded in), the second moment
`exp_avg_sq` and the weighted gradient sum `s`; per group the estimate `d`,
the weighted squared-gradient sum `gsq_weighted` and the step count `k`.
`d` and `gsq_weighted` are 0-d tensors on the parameters' device, so a step
never reads the device on the host. Each parameter group adapts its own d,
as one JAX `dadapt_adam` per label of `optax.multi_transform`.
"""
import typing as tp

import torch


class DAdaptAdam(torch.optim.Optimizer):
    """`lr` multiplies the adapted step size (1.0 in the solvers), `d0` is
    the initial estimate and `growth_rate` bounds its growth per step;
    `weight_decay` is decoupled, scaled by d * lr."""

    def __init__(self, params, lr: float = 1.0,
                 betas: tp.Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 d0: float = 1e-6, growth_rate: float = float("inf")):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, d0=d0,
                        growth_rate=growth_rate)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            self._group_step(group, params)
        return loss

    def _group_step(self, group: dict, params: tp.List[torch.Tensor]) -> None:
        beta1, beta2 = group["betas"]
        eps, decay = group["eps"], group["weight_decay"]
        device = params[0].device
        if "d" not in group:
            group["d"] = torch.tensor(group["d0"], dtype=torch.float32,
                                      device=device)
            group["gsq_weighted"] = torch.zeros((), device=device)
            group["k"] = 0
        d = group["d"].to(device)
        dlr = d * group["lr"]
        sqrt_beta2 = beta2 ** 0.5
        g_sq = sum(p.grad.float().square().sum() for p in params)
        gsq_weighted = (group["gsq_weighted"].to(device) * beta2
                        + g_sq * dlr.square() * (1 - beta2))
        sk_l1 = torch.zeros((), device=device)
        sk_sq_denom = torch.zeros((), device=device)
        for p in params:
            state = self.state[p]
            if not state:
                for name in ("exp_avg", "exp_avg_sq", "s"):
                    state[name] = torch.zeros_like(p)
            g = p.grad.to(p.dtype)
            m, v, s = state["exp_avg"], state["exp_avg_sq"], state["s"]
            m.mul_(beta1).add_(g * dlr * (1 - beta1))
            v.mul_(beta2).add_(g.square() * (1 - beta2))
            s.mul_(sqrt_beta2).add_(g * dlr * (1 - sqrt_beta2))
            sk_l1 += s.abs().sum()
            sk_sq_denom += (s.square() / (v.sqrt() + eps)).sum()
        d_hat = ((sk_sq_denom / (1 - beta2) - gsq_weighted / (1 - beta2))
                 / sk_l1.clamp_min(1e-12))
        grown = torch.minimum(torch.maximum(d, d_hat), d * group["growth_rate"])
        new_d = torch.where(sk_l1 > 0, grown, d)
        for p in params:
            state = self.state[p]
            update = -state["exp_avg"] / (state["exp_avg_sq"].sqrt() + eps)
            if decay > 0:
                update = update - decay * dlr * p
            p.add_(update)
        group["d"] = new_d
        group["gsq_weighted"] = gsq_weighted
        group["k"] += 1
