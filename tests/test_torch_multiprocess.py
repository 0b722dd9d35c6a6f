"""The port's distributed verbs across real processes on the CPU (gloo):
the barrier, the sharded save's `.tmp.done` protocol, metric averaging, the
epoch guard, broadcast and gradient sync, and the codec's data-parallel
step on 2 processes (the cases and expected values of the JAX package's
`tests/parallel/test_multiprocess.py` among them); the composed check
(`parallel/composed_check.py`) at dp 1 x fsdp 2 x tp 2 and a sharded train
step against the one-process step on the whole batch on 4.

The cases of one size run in one launch of workers (a module fixture), one
after another with a barrier between them; each test reads its case's
line from every worker. Each worker runs torch in one thread; a worker
that does not finish in time fails the tests with every worker's
output."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent


def _run(script: str, n: int, tmp_path, timeout: float) -> list:
    """`script` in `n` processes of one gloo group on a free local port;
    returns their outputs, failing unless every one exits 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, TMPDIR=str(tmp_path))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(rank), str(n), str(port),
             str(tmp_path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    if timed_out:
        pytest.fail("a worker timed out; outputs:\n" + "\n---\n".join(
            o or "" for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return outs


HEADER = textwrap.dedent("""
    import os, sys, time, traceback
    rank, n, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
    sys.path.insert(0, os.getcwd())
    import torch
    torch.set_num_threads(1)
    from audiocraft_tpu_torch.parallel import distrib
    distrib.init(f"tcp://127.0.0.1:{port}", world_size=n, rank=rank,
                 device="cpu")
    assert distrib.world_size() == n and distrib.rank() == rank
""")

RUNNER = textwrap.dedent("""
    for name in NAMES:
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
        try:
            value = globals()["case_" + name](os.path.join(tmp, name))
            print(f"CASE {name} OK {value}", flush=True)
        except Exception:
            print(f"CASE {name} FAIL", flush=True)
            traceback.print_exc()
        distrib.barrier(name)
""")


def _script(cases: dict, prelude: str = "") -> str:
    """One worker script running each case `case_<name>(tmp)` in turn;
    a case prints `CASE <name> OK <its return value>` or FAIL and its
    traceback."""
    parts = [HEADER, textwrap.dedent(prelude)]
    for name, body in cases.items():
        parts.append(f"def case_{name}(tmp):\n"
                     + textwrap.indent(textwrap.dedent(body), "    "))
    parts.append(f"NAMES = {list(cases)!r}\n" + RUNNER)
    return "\n".join(parts)


def _case(outs: list, name: str) -> set:
    """The values every worker's case `name` returned, failing with the
    workers' outputs unless each passed."""
    lines = [ln for o in outs for ln in o.splitlines()
             if ln.startswith(f"CASE {name} ")]
    passed = [ln for ln in lines if ln.startswith(f"CASE {name} OK")]
    assert len(passed) == len(outs), "\n---\n".join(outs)
    return {ln[len(f"CASE {name} OK "):] for ln in passed}


# the codec step's config (`tests/test_torch_codec_train.py::CFG`: SEANet
# 4 filters, dimension 32, ratios 10-8-8 at 16 kHz, 4 k-means codebooks of
# 8 codes, an MS-STFT discriminator of 2 filters)
SR, T, LR = 16000, 3200, 3e-4
CODEC_CFG = {
    "solver": "compression", "seed": 0, "sample_rate": SR, "channels": 1,
    "compression_model": "encodec", "encodec": {
        "autoencoder": "seanet", "quantizer": "rvq", "sample_rate": SR,
        "channels": 1, "renormalize": False,
        "seanet": {"dimension": 32, "n_filters": 4, "n_residual_layers": 1,
                   "ratios": [10, 8, 8], "lstm": 1, "norm": "weight_norm"},
        "rvq": {"n_q": 4, "bins": 8, "decay": 0.99, "kmeans_init": True,
                "threshold_ema_dead_code": 2.0}},
    "losses": {"adv": 4.0, "feat": 4.0, "l1": 0.1, "msspec": 2.0,
               "mel": 0.0, "sisnr": 0.0},
    "balancer": {"monitor": True},
    "adversarial": {"adversaries": ["msstftd"], "adv_loss": "hinge",
                    "feat_loss": "l1", "every": 1},
    "msstftd": {"filters": 2, "n_ffts": [128, 64], "hop_lengths": [32, 16],
                "win_lengths": [128, 64]},
    "mel": {"n_fft": 256, "hop_length": 64, "win_length": 256, "n_mels": 16},
    "msspec": {"range_start": 6, "range_end": 8, "n_mels": 8,
               "normalized": True, "alphas": False},
    "sisnr": {"segment": 0.05}, "mrstft": {},
    "optim": {"lr": LR, "max_norm": 1.0}}

TWO = {
    "barrier": """
        t0 = time.time()
        if rank == 1:
            time.sleep(2.0)
        distrib.barrier("sync-test")
        dt = time.time() - t0
        assert rank == 1 or dt > 1.5, f"rank 0 passed the barrier early: {dt}"
    """,
    "tmp_done": """
        from pathlib import Path
        from audiocraft_tpu_torch.utils.checkpoint import (
            checkpoint_name, load_checkpoint, save_checkpoint)
        ckdir = Path(tmp)
        path = ckdir / checkpoint_name(rank=rank, use_fsdp=False)
        if rank == 1:
            time.sleep(1.0)   # rank 1 writes late
        save_checkpoint({"w": torch.full((4,), float(rank))}, path,
                        is_sharded=True)
        distrib.barrier("after-save")
        token = ckdir / (checkpoint_name(rank=0, use_fsdp=False) + ".tmp.done")
        rank0 = ckdir / checkpoint_name(rank=0, use_fsdp=False)
        rank1 = ckdir / checkpoint_name(rank=1, use_fsdp=False)
        assert token.exists(), "missing .tmp.done after sharded save"
        assert rank0.exists() and rank1.exists()
        assert token.stat().st_mtime_ns >= rank0.stat().st_mtime_ns
        assert token.stat().st_mtime_ns >= rank1.stat().st_mtime_ns
        assert float(load_checkpoint(path)["w"][0]) == float(rank)
    """,
    "counts": """
        # rank 0 saw 3 batches averaging 1.0; rank 1 one batch of 5.0
        local = {"sisnr": 1.0 if rank == 0 else 5.0, "rvm": 2.0 * (rank + 1)}
        out = distrib.average_metrics(local, 3 if rank == 0 else 1)
        assert abs(out["sisnr"] - (1.0 * 3 + 5.0) / 4) < 1e-9, out
        assert abs(out["rvm"] - (2.0 * 3 + 4.0) / 4) < 1e-9, out
        return f"{out['sisnr']:.4f} {out['rvm']:.4f}"
    """,
    "per_key_weights": """
        # only rank 1 produced fad; no rank produced kld
        local = {"ce": 2.0 if rank == 0 else 4.0,
                 "fad": 0.0 if rank == 0 else 7.5, "kld": 1.0}
        out = distrib.average_metrics(
            local, 1, weights={"fad": 0.0 if rank == 0 else 1.0, "kld": 0.0})
        assert abs(out["ce"] - 3.0) < 1e-9, out
        assert abs(out["fad"] - 7.5) < 1e-9, out
        assert "kld" not in out, out
        return f"{out['ce']:.4f} {out['fad']:.4f}"
    """,
    "differing_keys": """
        keys = {"ce": 1.0} if rank == 0 else {"ce": 1.0, "fad": 2.0}
        try:
            distrib.average_metrics(keys)
        except AssertionError as exc:
            assert "key sets differ" in str(exc), exc
        else:
            raise AssertionError("differing key sets were averaged")
    """,
    "epoch_guard": """
        distrib.check_epoch_consistency(3)  # consistent: no raise
        try:
            distrib.check_epoch_consistency(3 if rank == 0 else 5)
        except RuntimeError:
            pass
        else:
            raise AssertionError("the epoch guard missed a desync")
    """,
    "broadcast_sync": """
        t = torch.full((3,), float(rank + 1))
        distrib.broadcast_tensors([t])
        assert t.tolist() == [1.0, 1.0, 1.0], t
        lin = torch.nn.Linear(2, 1, bias=False)
        lin.weight.grad = torch.full((1, 2), float(rank))
        distrib.sync_model(lin)
        assert lin.weight.grad.tolist() == [[0.5, 0.5]], lin.weight.grad
    """,
    "codec_dp": """
        import copy
        import math
        import numpy as np
        from audiocraft_tpu_torch.parallel.mesh import create_mesh
        from audiocraft_tpu_torch.solvers.compression import CompressionSolver

        def solver():
            s = CompressionSolver(copy.deepcopy(CODEC_CFG), device="cpu")
            step = s.optimizer.step
            def capture():
                s.grads = {k: p.grad.clone()
                           for k, p in s.model.named_parameters()}
                return step()
            s.optimizer.step = capture
            return s

        mesh = create_mesh(dp=2)
        plain, dp = solver(), solver()
        for i in range(2):
            if i:
                dp.load_state_dict(copy.deepcopy(plain.state_dict()))
                plain.disc_every = dp.disc_every = math.inf
            x = torch.from_numpy((np.random.RandomState(i).randn(4, 1, T)
                                  * 0.2).astype(np.float32))
            want, got = plain.train_step(x), dp.train_step(x, mesh)
            assert want.keys() == got.keys()
            for k, v in want.items():
                torch.testing.assert_close(got[k], v.float(), rtol=1e-4,
                                           atol=1e-6, msg=f"{i} {k}")
            for k, g in plain.grads.items():
                err = float((dp.grads[k] - g).norm())
                assert err <= 1e-4 * float(g.norm()), (i, k, err)
            diff = torch.cat([(dp.grads[k] - g).flatten()
                              for k, g in plain.grads.items()])
            norm = torch.cat([g.flatten() for g in plain.grads.values()])
            assert float(diff.norm()) <= 1e-5 * float(norm.norm()), i
            ours = dp.model.state_dict()
            for k, v in plain.model.state_dict().items():
                if "_codebook" in k:
                    torch.testing.assert_close(ours[k], v, rtol=0, atol=1e-5,
                                               msg=f"{i} {k}")
            for k, v in plain.balancer.avg.items():
                torch.testing.assert_close(dp.balancer.avg[k], v, rtol=1e-5,
                                           atol=0)
            for (name, a), (_, b) in zip(
                    plain.adv_losses["msstftd"].adversary.named_parameters(),
                    dp.adv_losses["msstftd"].adversary.named_parameters()):
                assert float((a - b).abs().max()) <= 2 * LR, name
        return f"{float(got['g_loss']):.4f}"
    """,
}

FOUR = {
    "composed": """
        from pathlib import Path
        from audiocraft_tpu_torch.models.presets import musicgen_lm
        from audiocraft_tpu_torch.parallel.checkpoint import restore_sharded
        from audiocraft_tpu_torch.parallel.composed_check import \\
            run_composed_check
        from audiocraft_tpu_torch.parallel.mesh import create_mesh
        from audiocraft_tpu_torch.parallel.sharding import shard_lm
        res = run_composed_check(tmp, dp=1, fsdp=2, tp_size=2)
        assert res["ce3_restored"] == res["ce3"], res
        assert abs(res["avg_ce"] - (res["ce3"] + 1.5)) < 1e-6, res
        ckdir = Path(tmp) / "composed_ckpt"
        # another layout: the blocks this rank needs are not in its file
        torch.manual_seed(0)
        other = shard_lm(musicgen_lm("xsmall", n_q=4, card=64, dim=64,
                                     num_heads=4, num_layers=2),
                         create_mesh(dp=2, fsdp=1, tp=2))
        try:
            restore_sharded(ckdir, {"model": other.state_dict()},
                            name="composed")
        except RuntimeError as exc:
            assert "save-time mesh layout" in str(exc), exc
        else:
            raise AssertionError("a changed layout restored")
        distrib.barrier("layout-checked")
        if rank == 0:
            (ckdir / "checkpoint_composed.th.tmp.done").unlink()
        distrib.barrier("token-removed")
        try:
            restore_sharded(ckdir, {"model": other.state_dict()},
                            name="composed")
        except RuntimeError as exc:
            assert "tmp.done" in str(exc), exc
        else:
            raise AssertionError("restored without the token")
        return f"{res['ce3']:.6f} {res['avg_ce']:.6f}"
    """,
    "sharded_step": """
        import numpy as np
        from torch.distributed.tensor import DTensor, Shard
        from audiocraft_tpu_torch.models.presets import musicgen_lm
        from audiocraft_tpu_torch.parallel.mesh import create_mesh
        from audiocraft_tpu_torch.parallel.sharding import shard_lm
        from audiocraft_tpu_torch.solvers.musicgen import (make_optimizer,
                                                           train_step)

        class Capture:
            def __init__(self, model):
                self.model = model
            def zero_grad(self):
                for p in self.model.parameters():
                    p.grad = None
            def step(self):
                self.grads = {k: (p.grad.full_tensor()
                                  if isinstance(p.grad, DTensor) else p.grad)
                              for k, p in self.model.named_parameters()
                              if p.grad is not None}
                return torch.zeros(())

        def build():
            torch.manual_seed(0)
            return musicgen_lm("xsmall", n_q=4, card=64, dim=64, num_heads=4,
                               num_layers=2)

        rs = np.random.RandomState(3)
        codes = torch.from_numpy(rs.randint(0, 64, (4, 4, 16)))
        codes[1, :, 10:] = 64  # padding: the special token
        tok = {"description": (rs.randint(0, 2048, (4, 4)),
                               (rs.rand(4, 4) > 0.3).astype(np.int64))}
        mesh = create_mesh(dp=1, fsdp=2, tp=2)
        plain, sharded = build(), shard_lm(build(), mesh)
        w = sharded.transformer.layers[0].self_attn.in_proj_weight
        assert isinstance(w, DTensor) and w.to_local().shape == (96, 32)
        assert list(w.placements)[1:] == [Shard(1), Shard(0)], w.placements
        cp, cs = Capture(plain), Capture(sharded)
        mp = train_step(plain, cp, codes, tok, dropout_seed=0)
        ms = train_step(sharded, cs, codes, tok, dropout_seed=0, mesh=mesh)
        assert abs(float(mp["ce"]) - float(ms["ce"])) < 1e-5, (mp, ms)
        assert cp.grads.keys() == cs.grads.keys()
        for k, g in cp.grads.items():
            err = float((g - cs.grads[k]).abs().max())
            assert err < 1e-5, (k, err)
        plain, sharded = build(), shard_lm(build(), mesh)
        op = make_optimizer(plain.parameters(), 1e-3)
        os_ = make_optimizer(sharded.parameters(), 1e-3)
        for i in range(2):
            a = train_step(plain, op, codes, tok, dropout_seed=i)
            b = train_step(sharded, os_, codes, tok, dropout_seed=i,
                           mesh=mesh)
            assert abs(float(a["ce"]) - float(b["ce"])) < 1e-5, (a, b)
            assert abs(float(a["grad_norm"]) - float(b["grad_norm"])) < 1e-5
        ours = sharded.state_dict()
        err = max(float((v - ours[k].full_tensor()).abs().max())
                  for k, v in plain.state_dict().items())
        assert err < 1e-5, err
        return f"{float(mp['ce']):.6f}"
    """,
}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(_script(TWO, prelude=f"SR, T, LR = {SR}, {T}, {LR}\n"
                                     f"CODEC_CFG = {CODEC_CFG!r}\n"),
                2, tmp_path_factory.mktemp("two"), timeout=240)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run(_script(FOUR), 4, tmp_path_factory.mktemp("four"),
                timeout=240)


def test_barrier_actually_synchronizes(two):
    _case(two, "barrier")


def test_sharded_checkpoint_tmp_done_protocol(two):
    """Every rank writes its file; the `.tmp.done` token appears only
    after all are complete, younger than each of them."""
    _case(two, "tmp_done")


@pytest.mark.parametrize("case", ["counts", "per_key_weights"])
def test_average_metrics_across_processes(two, case):
    """Batch-count weights, or a per-key weight 0 where a rank could not
    produce a metric, and a key of weight 0 everywhere dropped: every
    rank gets the same values."""
    assert len(_case(two, case)) == 1


def test_average_metrics_refuses_differing_key_sets(two):
    _case(two, "differing_keys")


def test_epoch_consistency_guard(two):
    """Out-of-sync restores raise on every rank."""
    _case(two, "epoch_guard")


def test_broadcast_and_sync_model(two):
    """`broadcast_tensors` copies rank 0's values; `sync_model` averages
    the gradients of a replicated model."""
    _case(two, "broadcast_sync")


def test_codec_data_parallel_step_equals_the_one_process_step(two):
    """`CompressionSolver.train_step(x, mesh)` on dp 2 against the same
    solver's step on the whole batch in one process (both in each worker,
    from the same seed): a first GAN step (k-means, a discriminator
    update), then a second from the one-process solver's state without a
    discriminator update (the EMA step and dead codes; after one, Adam's
    normalised step on near-zero gradients moves the generator's losses
    by more than rounding, as in `tests/test_torch_codec_train.py`):
    every metric rtol 1e-4 (atol 1e-6; `g_loss` is a hinge loss near 0
    times a balancer scale near 1e5), the generator's gradients (averaged,
    clipped) within 1e-5 of their L2 norm together and each within 1e-4
    of its own (sums of rows in another order, the smallest gradients
    near 1e-5), the codebooks atol 1e-5, the balancer's state rtol 1e-5,
    the discriminator within 2 x lr after its Adam step (a first step
    moves a weight by about lr x sign(g))."""
    assert len(_case(two, "codec_dp")) == 1


def test_composed_check_on_four_processes(four):
    """dp 1 x fsdp 2 x tp 2: sharded steps, a sharded save, a restore that
    continues within 1e-6 of the run that was not restarted, the epoch
    guard, exact cross-process averaging; a restore without the token, or
    under another layout, raises."""
    assert len(_case(four, "composed")) == 1


def test_sharded_step_equals_the_one_process_step(four):
    """dp 1 x fsdp 2 x tp 2 on a batch with padding and masked text: the
    sharded step's CE, gradient norm and every gradient (gathered) are the
    one-process step's on the whole batch within 1e-5 (f32); two steps of
    AdamW keep the weights within 1e-5; the weights are stored in the
    rules' placements."""
    assert len(_case(four, "sharded_step")) == 1
