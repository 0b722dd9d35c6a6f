"""Learning-rate schedules as plain functions of the update count
(counterpart of `audiocraft_tpu/optim/lr_schedulers.py`, which builds optax
schedules). Each returns the absolute rate at update `step` (0 for the first
update); `torch.optim.lr_scheduler.LambdaLR` takes `fn(step) / lr`."""
import math
import typing as tp

Schedule = tp.Callable[[int], float]


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       lr_min_ratio: float = 0.0,
                       cycle_length: float = 1.0) -> Schedule:
    """Linear warm-up to `lr`, then a cosine down to `lr * lr_min_ratio`."""
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        s = min((step - warmup_steps) / max(total_steps - warmup_steps, 1), 1.0)
        return lr * (lr_min_ratio + (1 - lr_min_ratio) * 0.5
                     * (1 + math.cos(math.pi * s / cycle_length)))
    return schedule


def polynomial_decay(lr: float, warmup_steps: int, total_steps: int,
                     end_lr: float = 0.0, power: float = 1.0,
                     zero_lr_warmup_steps: int = 0) -> Schedule:
    """Zero for `zero_lr_warmup_steps`, a linear warm-up, then a polynomial
    decay to `end_lr` at `total_steps`."""
    def schedule(step: int) -> float:
        if step < zero_lr_warmup_steps:
            return 0.0
        if step < warmup_steps + zero_lr_warmup_steps:
            return lr * (step - zero_lr_warmup_steps) / max(warmup_steps, 1)
        frac = 1 - (min(step, total_steps) - warmup_steps) / max(
            total_steps - warmup_steps, 1)
        return (lr - end_lr) * max(frac, 0.0) ** power + end_lr
    return schedule


def inverse_sqrt(lr: float, warmup_steps: int,
                 warmup_init_lr: float = 0.0) -> Schedule:
    """Linear warm-up from `warmup_init_lr`, then lr * sqrt(warmup / step)."""
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_init_lr + step * (lr - warmup_init_lr) / max(
                warmup_steps, 1)
        return lr * warmup_steps ** 0.5 / math.sqrt(max(step, 1))
    return schedule


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    """Linear warm-up to `lr`, then constant."""
    def schedule(step: int) -> float:
        return lr * step / max(warmup_steps, 1) if step < warmup_steps else lr
    return schedule


def get_lr_scheduler(name: tp.Optional[str], lr: float, total_updates: int,
                     cfg: tp.Optional[dict] = None) -> Schedule:
    """The schedule named `name` (None or 'none': constant `lr`), with its
    settings from `cfg`."""
    cfg = cfg or {}
    if name is None or name == "none":
        return lambda step: lr
    if name == "cosine":
        return cosine_with_warmup(lr, cfg.get("warmup", 0), total_updates,
                                  cfg.get("lr_min_ratio", 0.0),
                                  cfg.get("cycle_length", 1.0))
    if name == "polynomial_decay":
        return polynomial_decay(lr, cfg.get("warmup", 0), total_updates,
                                cfg.get("end_lr", 0.0), cfg.get("power", 1.0),
                                cfg.get("zero_lr_warmup_steps", 0))
    if name == "inverse_sqrt":
        return inverse_sqrt(lr, cfg.get("warmup", 0),
                            cfg.get("warmup_init_lr", 0.0))
    if name == "linear_warmup":
        return linear_warmup(lr, cfg.get("warmup", 0))
    raise ValueError(f"Unsupported LR Scheduler: {name}")
