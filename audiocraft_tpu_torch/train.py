"""The training entry point (counterpart of `audiocraft_tpu/train.py`).

    python -m audiocraft_tpu_torch.train solver=musicgen/debug \\
        dset=audio/example device=cpu optim.epochs=1

`solver=<name>` picks `configs/solver/<name>.yaml`; `<group>=<name>` with
no dot where `configs/<group>/<name>.yaml` exists composes that file over
it (e.g. `dset=audio/example`); every other `a.b=value` sets a key. The
experiment (`XP`) is named by the signature of these overrides, as in the
JAX package, and lives in `<dora dir>/xps/<sig>` (see `environment.py`),
where `config.json` and the checkpoint go. The solver runs on the config's
`device`: `cuda` by default, and for the `tpu` that the shared configs
name; asking for CUDA without a card raises. `--run_stage <stage>` runs one
stage (train, valid, evaluate or generate) instead of the epochs.

Several processes: start the module under torchrun (`torchrun
--nproc_per_node=N -m audiocraft_tpu_torch.train ...`); its `MASTER_ADDR`
and `WORLD_SIZE` make `parallel.distrib.init` start the process group
(NCCL on CUDA, gloo with `device=cpu`), and the batch size and each split's
`num_samples` are divided among the processes.
"""
import argparse
import json
import logging
import random
import typing as tp

import numpy as np
import torch

from .config import CONFIG_ROOT, XP, _deep_update, apply_overrides, load_config
from .environment import AudioCraftEnvironment
from .parallel import distrib

logger = logging.getLogger(__name__)

SPLITS = ("train", "valid", "evaluate", "generate")


def world_size() -> int:
    """The processes of the run: the process group's (1 without one)."""
    return distrib.world_size()


def solver_device(cfg: dict) -> str:
    device = cfg.get("device") or "cuda"
    return "cuda" if device == "tpu" else device


def get_solver(cfg: dict):
    """The solver of `cfg` on its device, the global batch size (and each
    split's `num_samples`) divided among the run's processes."""
    from .solvers import builders
    dataset = cfg.get("dataset") or {}
    n = world_size()
    if "batch_size" in dataset:
        assert dataset["batch_size"] % n == 0, (
            f"Batch size must be divisible by number of hosts, got "
            f"{dataset['batch_size']} and {n}")
        dataset["batch_size"] //= n
        for split in SPLITS:
            own = dataset.get(split)
            if isinstance(own, dict) and own.get("num_samples") is not None:
                assert own["num_samples"] % n == 0
                own["num_samples"] //= n
    return builders.get_solver(cfg, device=solver_device(cfg))


def get_solver_from_xp(xp: XP, override_cfg: tp.Optional[dict] = None,
                       restore: bool = True, load_best: bool = True,
                       ignore_state_keys: tp.Sequence[str] = (),
                       disable_fsdp: bool = True):
    """The solver of an experiment (its config with `override_cfg` merged
    in), restored from its checkpoint unless `restore` is False."""
    logger.info(f"Loading solver from XP {xp.sig}. Overrides used: {xp.delta}")
    cfg = dict(xp.cfg)
    if override_cfg is not None:
        _deep_update(cfg, override_cfg)
    cfg["folder"] = str(xp.folder)
    solver = get_solver(cfg)
    if restore:
        solver.restore()
    return solver


def get_solver_from_sig(sig: str, *args, **kwargs):
    """The solver of the experiment `<dora dir>/xps/<sig>` (its
    `config.json`)."""
    folder = AudioCraftEnvironment.get_dora_dir() / "xps" / sig
    cfg_file = folder / "config.json"
    cfg = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
    xp = XP(cfg, {"sig": sig})
    xp.folder = folder
    return get_solver_from_xp(xp, *args, **kwargs)


def init_seed_and_system(cfg: dict) -> None:
    """Seed Python's, numpy's and torch's generators from `seed`, and give
    torch `num_threads` CPU threads."""
    seed = cfg.get("seed", 2036)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logger.info("Setting seed %d", seed)
    if cfg.get("num_threads"):
        torch.set_num_threads(int(cfg["num_threads"]))


def compose(overrides: tp.Sequence[str]) -> tp.Tuple[dict, dict]:
    """(config, override delta) of the command line's overrides."""
    solver_name = None
    groups, rest = [], []
    for override in overrides:
        key, _, value = override.partition("=")
        if key == "solver":
            solver_name = value
        elif "." not in key and (CONFIG_ROOT / key / f"{value}.yaml").exists():
            groups.append((key, value))
        else:
            rest.append(override)
    if solver_name is None:
        raise ValueError("pass solver=<name>")
    cfg = load_config(f"solver/{solver_name}")
    delta: tp.Dict[str, tp.Any] = {}
    for group, name in groups:
        _deep_update(cfg, load_config(f"{group}/{name}"))
        delta[group] = name
    delta.update(apply_overrides(cfg, rest))
    delta["solver"] = solver_name
    return cfg, delta


def main(argv: tp.Optional[tp.List[str]] = None):
    """Compose the config, make the experiment's folder, build the solver
    and run it (or one stage). Returns what the run returns."""
    parser = argparse.ArgumentParser(prog="audiocraft_tpu_torch.train")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides like solver=musicgen a.b=c")
    parser.add_argument("--run_stage", default=None,
                        help="run a single stage (train/valid/evaluate/generate)")
    args = parser.parse_args(argv)
    cfg, delta = compose(args.overrides)
    xp = XP(cfg, delta)
    xp.folder.mkdir(parents=True, exist_ok=True)
    cfg["folder"] = str(xp.folder)
    logging.basicConfig(level=(cfg.get("logging") or {}).get("level", "INFO"),
                        format="[%(levelname)s %(name)s] %(message)s")
    logger.info("XP signature: %s folder: %s", xp.sig, xp.folder)
    init_seed_and_system(cfg)
    distrib.init(device=solver_device(cfg))
    (xp.folder / "config.json").write_text(json.dumps(cfg, default=str))
    solver = get_solver(cfg)
    if args.run_stage:
        return solver.run_one_stage(args.run_stage)
    return solver.run()


if __name__ == "__main__":
    main()
