"""Grid CLI: plan or launch a declared sweep.

    python -m audiocraft_tpu_torch.grids <family>.<grid> [--run] [--max-jobs N] [-o KEY=VALUE ...]

Without --run, prints the job table. With --run, runs each job in turn
through `audiocraft_tpu_torch.train.main` with the job's overrides followed
by the `-o` overrides, so that a later `-o` wins (a cluster runner would
instead fan the printed job list out over hosts).
"""
import argparse
import importlib
import sys

from ._base_explorers import BaseExplorer


def list_grids():
    import pkgutil
    import audiocraft_tpu_torch.grids as grids_pkg
    names = []
    for family in pkgutil.iter_modules(grids_pkg.__path__):
        if not family.ispkg:
            continue
        sub = importlib.import_module(f"audiocraft_tpu_torch.grids.{family.name}")
        for mod in pkgutil.iter_modules(sub.__path__):
            if not mod.name.startswith("_"):
                names.append(f"{family.name}.{mod.name}")
    return sorted(names)


def find_explorer(module_name: str) -> BaseExplorer:
    try:
        mod = importlib.import_module(f"audiocraft_tpu_torch.grids.{module_name}")
    except ModuleNotFoundError:
        avail = "\n  ".join(list_grids())
        raise SystemExit(
            f"unknown grid {module_name!r}; available grids:\n  {avail}")
    for attr in vars(mod).values():
        if isinstance(attr, BaseExplorer):
            return attr
    raise SystemExit(f"no explorer declared in grids.{module_name}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="audiocraft_tpu_torch.grids")
    parser.add_argument("grid", help="e.g. musicgen.musicgen_base_32khz")
    parser.add_argument("--run", action="store_true",
                        help="launch jobs sequentially via audiocraft_tpu_torch.train")
    parser.add_argument("--max-jobs", type=int, default=None)
    parser.add_argument("-o", "--override", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="extra override applied to every job "
                             "(e.g. -o datasource.train=egs/my/train)")
    args = parser.parse_args(argv)

    explorer = find_explorer(args.grid)
    jobs = explorer.collect()
    if args.max_jobs is not None:
        jobs = jobs[:args.max_jobs]

    print(f"grid {args.grid}: {len(jobs)} job(s), stages {explorer.stages()}")
    for i, job in enumerate(jobs):
        extras = {k: v for k, v in job.overrides.items() if k != "solver"}
        brief = " ".join(f"{k}={v}" for k, v in list(extras.items())[:6])
        if len(extras) > 6:
            brief += f" (+{len(extras) - 6} more)"
        label = f" [{job.label}]" if job.label else ""
        print(f"  #{i} sig={job.sig} chips={job.chips}{label} "
              f"solver={job.solver} {brief}")

    if args.run:
        from ..train import main as train_main
        for i, job in enumerate(jobs):
            print(f"--- launching job #{i} sig={job.sig} ---", flush=True)
            train_main(job.argv() + list(args.override))
    return jobs


if __name__ == "__main__":
    main()
