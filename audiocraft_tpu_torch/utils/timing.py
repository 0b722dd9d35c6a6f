"""Device timing of a kernel call on a CUDA card."""
import typing as tp

import torch

SPIN_CYCLES = 2_000_000     # about 1 ms at the H100's clock


def time_ms(fn: tp.Callable[[], tp.Any], n: int = 50,
            flush_bytes: int = 0) -> float:
    """Median device milliseconds of `fn()` over n warm calls, each timed
    with its own CUDA events. Before each call a buffer larger than L2 is
    rewritten (with `flush_bytes`), so the inputs come from HBM as in the
    decode loop, where the other layers' traffic evicts them; then the
    device spins for about a millisecond, so that the events and `fn`'s
    kernels are all queued before the device reaches them and the interval
    holds device work only, not the host's launch latency."""
    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]
