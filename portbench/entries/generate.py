"""Entry `generate`: text-to-music requests through `MusicGen.generate`
(`models/genmodel.py`), one client in a closed loop.

Set-up builds the configuration's LM (`models.builders.get_lm_model` on
the solver config at the configuration's widths, on the meta device) and
codec (`builders.<codec builder>`), loads weights drawn on the card from
the seed, wraps them in `MusicGen`, holds its T5 conditioner to the hash
tokenizer (`harness/conditioning.py`), and sends one sampled and one
greedy request of the cell's shapes. Each timed item is one request of
the traffic, which keeps the rows the check may read. The check runs the
reference over the rows of a sample of greedy and of sampled requests: T5
and the output projection of the request's texts (padded to the request's
longest, as the program pads them), the LM over the served tokens with the
CFG combine, and the codec decode of the served tokens.
"""
import time

from harness import conditioning, counts, traffic as traffic_mod, weights as W
from reference import musicgen as ref


class State:
    pass


def _lm_arch(cfg: dict) -> dict:
    lm = dict(cfg["transformer_lm"])
    lm.update(delays=cfg["delays"], cfg_coef=cfg["cfg_coef"], t5=cfg["t5"])
    return lm


def setup(ctx) -> State:
    torch = ctx.torch
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.models import MusicGen, builders
    cfg = ctx.cell.config
    s = State()
    s.marks = {"imported": time.perf_counter()}
    s.dtype = getattr(torch, cfg["serve_dtype"])
    solver = load_config(cfg["solver"])
    solver["transformer_lm"].update(cfg["transformer_lm"])
    solver["conditioners"]["description"]["t5"]["name"] = cfg["t5"]["name"]
    lm = builders.get_lm_model(solver, device="meta", dtype=s.dtype)
    lm = lm.to_empty(device=ctx.device)
    codec = getattr(builders, cfg["codec"]["builder"])(
        device=ctx.device).to(s.dtype)
    s.lm_shapes, s.codec_shapes = W.shapes_of(lm), W.shapes_of(codec)
    s.mg = MusicGen(ctx.cell.name, codec, lm, device=ctx.device)
    conditioning.hold_to_hash(lm, cfg["t5"]["vocab_size"])
    s.marks["built"] = time.perf_counter()
    load(s, ctx)
    ctx.sync()
    s.marks["weights"] = time.perf_counter()
    s.frames = int(ctx.cell.traffic["seconds_per_text"] * codec.frame_rate)
    s.forwards = s.frames + max(cfg["delays"])
    s.traced_launches = 0
    for i in traffic_mod.TextToMusic.WARMUP:
        item(s, i, ctx, keep=False)
        ctx.sync()
        s.marks[f"warm-up {i}"] = time.perf_counter()
    for spans in (s.replay_ms, s.codec_ms, s.flops):
        spans.clear()
    if ctx.traced:
        _time_codec_decode(s, ctx)
    return s


def load(s: State, ctx) -> None:
    """Weights, sampler seed and traffic of `ctx.seed`."""
    s.traffic = traffic_mod.make(ctx.cell.traffic, ctx.seed)
    s.mg.lm.load_state_dict(W.make_weights(
        s.lm_shapes, s.dtype, W.sub_seed(ctx.seed, 0), ctx.device))
    s.mg.compression_model.load_state_dict(W.make_weights(
        s.codec_shapes, s.dtype, W.sub_seed(ctx.seed, 1), ctx.device))
    s.mg.set_seed(W.sub_seed(ctx.seed, 2))
    s.kept = {}
    s.replay_ms, s.codec_ms, s.flops = [], [], []


def _time_codec_decode(s: State, ctx) -> None:
    """The benchmark's span around the codec decode: synchronised host
    clock, ms per request."""
    codec = s.mg.compression_model
    plain = codec.decode

    def decode(*args, **kwargs):
        ctx.sync()
        t = time.perf_counter()
        out = plain(*args, **kwargs)
        ctx.sync()
        s.codec_ms.append((time.perf_counter() - t) * 1e3)
        return out

    codec.decode = decode


def item(s: State, i: int, ctx, keep: bool = True) -> float:
    """Request i; returns the seconds of audio it asked for."""
    p = ctx.cell.traffic
    req = s.traffic.request(i)
    s.mg.set_generation_params(duration=p["seconds_per_text"],
                               use_sampling=not req.greedy, top_k=p["top_k"],
                               cfg_coef=p["cfg_coef"])
    wav, tokens = s.mg.generate(req.texts, return_tokens=True)
    if ctx.device.type == "cuda":
        from audiocraft_tpu_torch.models import lm as lm_module
        s.replay_ms.append(
            lm_module.decode_graph_stats.last_replay_ms_per_step())
    ids, _ = ref.hash_tokens(req.texts, ctx.cell.config["t5"]["vocab_size"])
    s.flops.append(counts.generate_flops(
        ctx.cell.config["transformer_lm"], ctx.cell.config["t5"],
        2 * len(req.texts), s.forwards, ids.shape[1]))
    if keep:
        rows = s.traffic.rows_to_check(i)
        s.kept[i] = (rows, tokens[rows].clone(), wav[rows].clone())
    return len(req.texts) * p["seconds_per_text"]


def before_trace(s: State, ctx) -> None:
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    s.launches_before = decode_attention.launches


def after_trace(s: State, ctx) -> None:
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    s.traced_launches = decode_attention.launches - s.launches_before


def end_to_end(s: State, window, ctx) -> dict:
    audio = sum(work for _, _, work in window.items)
    done = len(window.items)
    return {"gen_audio_s_per_s": audio / window.seconds,
            "request_s": window.seconds / max(done, 1)}


def release(s: State) -> None:
    s.mg = None


def readings(s: State, ctx, chosen, control=None) -> dict:
    """Over the kept rows of the requests `chosen`: the widest gap of a
    served greedy token's CFG logit below the reference's best
    (`logit_gap`), the widest gap of a served sampled token's below the
    reference's `top_k`-th best
    (`topk_gap`: 0 while every sampled token lies in the reference's top
    k), and the worst relative L2 distance of a served waveform from the
    reference's decode of the same tokens. With `control` (a `Precision`),
    also the same numbers of the control: the token that it puts first at
    each position, or samples from its own top k, and its decode's
    distance."""
    torch = ctx.torch
    cfg = ctx.cell.config
    top_k = int(ctx.cell.traffic["top_k"])
    ref.strict_float32()
    arch = _lm_arch(cfg)
    lm_sd = {k: v.float() for k, v in W.make_weights(
        s.lm_shapes, s.dtype, W.sub_seed(ctx.seed, 0), ctx.device).items()}
    codec_sd = {k: v.float() for k, v in W.make_weights(
        s.codec_shapes, s.dtype, W.sub_seed(ctx.seed, 1), ctx.device).items()}
    keys = ["logit_gap", "topk_gap", "wave_rel_l2"]
    out = dict.fromkeys(keys + ([k + ".control" for k in keys]
                                if control is not None else []), 0.0)
    sampler = torch.Generator(ctx.device).manual_seed(
        W.sub_seed(ctx.seed, 3))

    def worse(key, value):
        out[key] = max(out[key], float(value))

    def rel(got, want):
        return torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)

    with torch.no_grad():
        for i in chosen:
            rows, tokens, wav = s.kept[i]
            req = s.traffic.request(i)
            gap, k = ("logit_gap", 1) if req.greedy else ("topk_gap", top_k)
            B = len(req.texts)
            ids, mask = ref.hash_tokens(req.texts + [None] * B,
                                        cfg["t5"]["vocab_size"])
            ids, mask = ids.to(ctx.device), mask.to(ctx.device)
            for j, r in enumerate(rows):
                pair = [r, B + r]
                cross = ref.text_condition(lm_sd, arch, ids[pair], mask[pair],
                                           ref.F32)
                worse(gap, ref.served_gaps(lm_sd, arch, tokens[j], cross,
                                           top_k=k))
                want = ref.codec_decode(codec_sd, cfg["codec"], tokens[j:j + 1],
                                        ref.F32)
                worse("wave_rel_l2", rel(wav[j:j + 1].float(), want))
                if control is None:
                    continue
                cross_c = ref.text_condition(lm_sd, arch, ids[pair],
                                             mask[pair], control)
                worse(gap + ".control", ref.served_gaps(
                    lm_sd, arch, tokens[j], cross, control, cross_c, top_k=k,
                    generator=sampler))
                worse("wave_rel_l2.control", rel(ref.codec_decode(
                    codec_sd, cfg["codec"], tokens[j:j + 1], control), want))
    return out


def check(s: State, ctx) -> dict:
    if not s.kept:
        return {}
    limits = ctx.cell.workload["limits"]
    got = readings(s, ctx, s.traffic.requests_to_check(sorted(s.kept)))
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def calibration_readings(s: State, ctx, control: bool) -> dict:
    """For `portbench/calibrate.py`: the seed's weights, sampler and
    traffic loaded anew, its first sampled and first greedy request served
    at the cell's size, and the numbers compared (with `control`, the
    control's too)."""
    load(s, ctx)
    chosen = [0, int(ctx.cell.traffic["greedy_every"]) - 1]
    out = {}
    for i in chosen:
        t = time.perf_counter()
        item(s, i, ctx)
        ctx.sync()
        out[f"request_{i}_s"] = time.perf_counter() - t
    out.update(readings(s, ctx, chosen, ref.FP8_STREAM if control else None))
    return out
