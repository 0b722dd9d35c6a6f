"""`mfu.<suffix>`: the model FLOPs' share of the card's bf16 peak (989
TFLOP/s), in %, over the timed window (`harness/counts.py`). Serving
(`mfu.gen`, `mfu.req`): each request's LM FLOPs (2 N per row per forward
plus attention over each forward's length, the text keys' projection and
T5 once per row, CFG rows included) summed over the window's requests,
over the window's wall time. Training (`mfu.train`): 6 N per token over
the LM trunk plus 12 L T^2 d per sample, per step, over the window's mean
step time. Moves the cell's end-to-end rate or time."""
from harness import counts


def read(view, suffix):
    s, w = view.state, view.window
    done = len(w.items)
    if not done or w.seconds <= 0:
        return None
    peak = counts.PEAKS["bf16_flops"]
    if hasattr(s, "flops"):
        return 100.0 * sum(s.flops[:done]) / w.seconds / peak
    if hasattr(s, "n_trunk"):
        step_s = sum(t for _, t, _ in w.items) / done
        flops = counts.train_step_flops(s.n_trunk, s.traffic.batch,
                                        s.frames + 1, s.layers, s.dim)
        return 100.0 * flops / step_s / peak
    return None
