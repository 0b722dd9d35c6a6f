"""`k2_roofline.<suffix>`: K2's (`csrc/flash_causal_attention.cu`) share
of its roofline over the traced training steps, in %: the least time of
its forward and backward calls (bf16 operations over 989 TFLOP/s, or
bytes over 3.35 TB/s, whichever is longer; `harness/counts.py`) over the
device time of its kernels in the trace (forward; delta, dK/dV and dQ).
The kernels are checked against `flash_causal_attention.launches` and
`.backward_launches`; nothing is returned where they disagree. Moves
`train_audio_s_per_s`."""
from harness import counts

FORWARD = r"(wgmma_path|fma_path)::fwd_kernel"
BACKWARD = r"(wgmma_path|fma_path)::(dkdv_kernel|dq_kernel)|delta_kernel"


def read(view, suffix):
    s, trace = view.state, view.trace
    if trace is None or not hasattr(s, "launches"):
        return None
    fwd, bwd = trace.kernels(FORWARD), trace.kernels(BACKWARD)
    n_fwd, n_bwd = s.launches
    if not fwd or len(fwd) != n_fwd or len(bwd) != 3 * n_bwd:
        return None
    B, T = s.traffic.batch, s.frames + 1
    H, D = s.heads, s.dim // s.heads
    bound = (n_fwd * counts.k2_bound_s(B, T, H, D, backward=False)
             + n_bwd * counts.k2_bound_s(B, T, H, D, backward=True))
    device_s = sum(c.end - c.start for c in fwd + bwd) / 1e9
    return 100.0 * bound / device_s
