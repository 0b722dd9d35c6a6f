"""One multi-process flow through every distributed verb (counterpart of
`audiocraft_tpu/parallel/composed_check.py`):

    sharded train steps -> sharded save (`.tmp.done` two-phase commit) ->
    restore on every rank -> epoch-consistency guard -> one more step,
    equal to the run that was not restarted -> cross-process metric
    averaging.

Run from every rank of a process group that `distrib.init` started, with
dp x fsdp x tp_size ranks (the gloo test harness in
`tests/test_torch_multiprocess.py`).
"""
import typing as tp
from pathlib import Path

import numpy as np
import torch


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Zero Adam state for every parameter, as the optimizer's first step
    makes it (the JAX package's `init_train_state`): the template a
    restore fills."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {"step": torch.tensor(0.0),
                                  "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)}


def train_state(model: torch.nn.Module, optimizer) -> dict:
    """The state a sharded checkpoint holds: weights, Adam state, the
    schedule and the step."""
    return {"model": model.state_dict(),
            "optim": optimizer.optimizer.state_dict(),
            "sched": optimizer.scheduler.state_dict(),
            "step": torch.tensor(optimizer.scheduler.last_epoch)}


def load_train_state(model: torch.nn.Module, optimizer, state: dict) -> None:
    model.load_state_dict(state["model"])
    optimizer.optimizer.load_state_dict(state["optim"])
    optimizer.scheduler.load_state_dict(state["sched"])


def run_composed_check(tmpdir: tp.Union[str, Path], dp: int = 2,
                       fsdp: int = 2, tp_size: int = 2) -> dict:
    from ..models.presets import musicgen_lm
    from ..solvers.musicgen import make_optimizer, train_step
    from . import distrib
    from .checkpoint import restore_sharded, save_sharded
    from .mesh import create_mesh
    from .sharding import shard_lm

    n = dp * fsdp * tp_size
    assert distrib.world_size() == n, (distrib.world_size(), n)
    mesh = create_mesh(dp=dp, fsdp=fsdp, tp=tp_size)
    device = distrib.comm_device()

    def sharded_lm(seed: int):
        torch.manual_seed(seed)
        model = musicgen_lm("xsmall", n_q=4, card=64, dim=64, num_heads=4,
                            num_layers=2, device=device)
        shard_lm(model, mesh)
        optimizer = make_optimizer(model.parameters(), 1e-4)
        init_optimizer_state(optimizer.optimizer)
        return model, optimizer

    model, optimizer = sharded_lm(0)
    # the same global batch on every rank; each runs its rows
    B, K, T = n, model.n_q, 16
    rs = np.random.RandomState(7)
    codes = torch.from_numpy(rs.randint(0, model.card, (B, K, T))).to(device)
    tokenized = {"description": (rs.randint(0, 2048, (B, 4)),
                                 np.ones((B, 4), np.int64))}

    def step(m, opt, i: int) -> float:
        return float(train_step(m, opt, codes, tokenized, dropout_seed=i,
                                mesh=mesh)["ce"])

    # ---- sharded train steps
    for i in range(2):
        ce2 = step(model, optimizer, i)

    # ---- sharded save, then the 3rd step of the run that goes on
    ckdir = Path(tmpdir) / "composed_ckpt"
    save_sharded(train_state(model, optimizer), ckdir, name="composed")
    distrib.barrier("composed-saved")
    ce3 = step(model, optimizer, 2)

    # ---- restart: fresh init, every rank restores its own blocks
    fresh, fresh_opt = sharded_lm(9)
    restored = restore_sharded(ckdir, train_state(fresh, fresh_opt),
                               name="composed")
    load_train_state(fresh, fresh_opt, restored)
    restored_step = int(restored["step"])
    assert restored_step == 2, restored_step

    # ---- epoch-consistency guard across ranks
    distrib.check_epoch_consistency(restored_step)
    desync_raised = False
    try:
        distrib.check_epoch_consistency(restored_step + distrib.rank())
    except RuntimeError:
        desync_raised = True
    assert desync_raised or distrib.world_size() == 1, \
        "epoch guard missed a desynchronized restore"

    # ---- the restored run continues like the one that was not restarted
    ce3_restored = step(fresh, fresh_opt, 2)
    assert abs(ce3_restored - ce3) < 1e-6, (ce3, ce3_restored)

    # ---- cross-process weighted averaging of an eval metric
    avg = distrib.average_metrics({"ce": ce3 + distrib.rank()}, count=1)
    if distrib.world_size() == 2:
        assert abs(avg["ce"] - (ce3 + 0.5)) < 1e-6, (avg, ce3)

    return {"ce2": ce2, "ce3": ce3, "ce3_restored": ce3_restored,
            "avg_ce": avg["ce"], "rank": distrib.rank()}
