"""Entry `train_step`: `MusicGenSolver.run_step` (`solvers/musicgen.py`)
on one batch held on the card.

Set-up builds the solver from the configuration's training solver config
(`solvers.get_solver`), holds its T5 conditioner to the hash tokenizer
(`harness/conditioning.py`), loads weights drawn on the card from the seed into
its LM (f32 parameters), makes the traffic's batch (codes drawn on the
card, texts tokenized by the LM's conditioner), and runs three steps
through `run_step`: the warm-up, and the steps the check holds against the
reference. From the optimizer's state after the first step it reads each
leaf's gradient norm (AdamW's first moment over 1 - beta1), and after the
third each leaf's change from the loaded weights. Each timed item is one
more `run_step` on the same batch.
"""
import statistics
import time

from harness import conditioning, traffic as traffic_mod, weights as W
from reference import musicgen as ref

CHECKED_STEPS = 3


class State:
    pass


def _solver_config(cell) -> dict:
    from audiocraft_tpu_torch.config import apply_overrides, load_config
    cfg = cell.config
    train = cfg["train"]
    solver = load_config(train["solver"])
    solver["transformer_lm"].update(cfg["transformer_lm"])
    solver["conditioners"]["description"]["t5"]["name"] = cfg["t5"]["name"]
    apply_overrides(solver, [f"{k}={v}" for k, v in train["overrides"].items()]
                    + [f"dataset.batch_size={cell.traffic['batch']}"])
    return solver


def setup(ctx) -> State:
    torch = ctx.torch
    from audiocraft_tpu_torch.solvers import get_solver
    cell, cfg = ctx.cell, ctx.cell.config
    s = State()
    s.marks = {"imported": time.perf_counter()}
    s.solver_cfg = _solver_config(cell)
    s.solver = get_solver(s.solver_cfg, device=ctx.device)
    lm = s.solver.model
    conditioning.hold_to_hash(lm, cfg["t5"]["vocab_size"])
    s.marks["built"] = time.perf_counter()
    s.dtype = getattr(torch, cfg["train"]["param_dtype"])
    s.shapes = W.shapes_of(lm)
    s.frames = int(cell.traffic["seconds"] * cfg["codec"]["frame_rate"])
    s.n_trunk = sum(p.numel() for n, p in lm.named_parameters()
                    if not n.startswith("condition_provider"))
    s.layers, s.dim, s.heads = lm.num_layers, lm.dim, lm.num_heads
    s.launches = (0, 0)
    load(s, ctx)
    return s


def load(s: State, ctx) -> None:
    """Weights, batch and a fresh optimizer state for `ctx.seed`, then the
    checked steps, with the losses, first gradient norms and changes that
    the check reads."""
    torch = ctx.torch
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    lm = s.solver.model
    s.traffic = traffic_mod.make(ctx.cell.traffic, ctx.seed)
    start = W.make_weights(s.shapes, s.dtype, W.sub_seed(ctx.seed, 0),
                           ctx.device)
    lm.load_state_dict(start)
    codes = s.traffic.codes(torch, lm.n_q, lm.card, s.frames, ctx.device)
    s.batch = {"codes": codes, "padding_mask": torch.ones(
        codes.shape[0], s.frames, dtype=torch.bool, device=ctx.device),
        "tokenized": lm.condition_provider.tokenize(
            [ConditioningAttributes(text={"description": t})
             for t in s.traffic.texts()])}
    opt = s.solver.optimizer.optimizer
    opt.state.clear()
    ctx.sync()
    s.marks["weights and batch"] = time.perf_counter()
    names = {id(p): n for n, p in lm.named_parameters()}
    beta1 = opt.param_groups[0]["betas"][0]
    s.losses, s.grads = [], {}
    for idx in range(CHECKED_STEPS):
        metrics = s.solver.run_step(idx, s.batch, {})
        s.losses.append(float(metrics["ce"]))
        s.marks[f"step {idx}"] = time.perf_counter()
        if idx == 0:
            s.grads = {names[id(p)]: float(torch.linalg.vector_norm(
                st["exp_avg"]) / (1 - beta1)) for p, st in opt.state.items()}
    s.change = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
                for n, p in lm.named_parameters() if p.requires_grad}
    s.steps_done = CHECKED_STEPS


def item(s: State, i: int, ctx) -> float:
    """One `run_step`; returns the seconds of audio it consumed."""
    s.solver.run_step(s.steps_done + i, s.batch, {})
    return s.traffic.batch * ctx.cell.traffic["seconds"]


def before_trace(s: State, ctx) -> None:
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    s.launches_before = (fca.launches, fca.backward_launches)


def after_trace(s: State, ctx) -> None:
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    s.launches = (fca.launches - s.launches_before[0],
                  fca.backward_launches - s.launches_before[1])


def end_to_end(s: State, window, ctx) -> dict:
    times = [t for _, t, _ in window.items]
    audio = sum(work for _, _, work in window.items)
    p90 = (statistics.quantiles(times, n=10, method="inclusive")[8]
           if len(times) >= 2 else times[0])
    return {"train_audio_s_per_s": audio / window.seconds,
            "train_step_p90_s": p90}


def release(s: State) -> None:
    s.solver = None
    s.batch = None


def compare(program: dict, reference: dict) -> dict:
    """The three numbers compared: the worst relative gap of a step's
    loss, and, over the leaves whose reference gradient is above a
    thousandth of the median leaf's, the worst gap of a leaf's first
    gradient norm and of its change after the checked steps, each against
    the larger of that leaf's reference norm and the median leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"],
                                                  reference["losses"]))
    ref_grads = reference["grads"]
    median_grad = statistics.median(ref_grads.values())
    leaves = [n for n, g in ref_grads.items() if g > 1e-3 * median_grad]
    out = {"loss_rel": loss}
    for key in ("grads", "change"):
        want = reference[key]
        median = statistics.median(want[n] for n in leaves)
        out[key] = max(abs(program[key].get(n, 0.0) - want[n])
                       / max(want[n], median) for n in leaves)
    return {"loss_rel": out["loss_rel"], "grad_norm_rel": out["grads"],
            "change_norm_rel": out["change"]}


def reference_readings(s: State, ctx, precision=ref.F32, rows=None) -> dict:
    """The reference's three steps from the same weights and batch."""
    torch = ctx.torch
    ref.strict_float32()
    cfg = ctx.cell.config
    arch = dict(cfg["transformer_lm"], delays=cfg["delays"], t5=cfg["t5"])
    sd = {k: v.float() for k, v in W.make_weights(
        s.shapes, s.dtype, W.sub_seed(ctx.seed, 0), ctx.device).items()}
    frames = s.frames
    codes = s.traffic.codes(torch, arch["n_q"], arch["card"], frames,
                            ctx.device)
    ids, mask = ref.hash_tokens(s.traffic.texts(), cfg["t5"]["vocab_size"])
    opt = s.solver_cfg["optim"]
    optim = {"lr": float(opt["lr"]), "betas": tuple(opt["adam"]["betas"]),
             "eps": float(opt["adam"]["eps"]),
             "weight_decay": float(opt["adam"]["weight_decay"]),
             "max_norm": float(opt["max_norm"])}
    return ref.train_steps(sd, arch, codes, ids.to(ctx.device),
                           mask.to(ctx.device), optim, CHECKED_STEPS,
                           precision, rows=rows)


def program_readings(s: State) -> dict:
    return {"losses": s.losses, "grads": s.grads, "change": s.change}


def check(s: State, ctx) -> dict:
    limits = ctx.cell.workload["limits"]
    got = compare(program_readings(s), reference_readings(s, ctx))
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def calibration_readings(s: State, ctx, control: bool) -> dict:
    """For `portbench/calibrate.py`: the seed's weights, batch and a fresh
    optimizer through the checked steps, and the numbers compared; with
    `control`, also the control's (the reference in float8) and those of
    the reference with half the batch left out, the loss the mean over
    the rest."""
    load(s, ctx)
    reference = reference_readings(s, ctx)
    out = compare(program_readings(s), reference)
    out.update(losses=s.losses, reference_losses=reference["losses"])
    if control:
        for name, kw in (("control", dict(precision=ref.FP8)),
                         ("half_batch", dict(rows=slice(0, s.traffic.batch // 2)))):
            got = compare(reference_readings(s, ctx, **kw), reference)
            out.update({f"{k}.{name}": v for k, v in got.items()})
    return out
