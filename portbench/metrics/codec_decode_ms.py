"""`codec_decode_ms.<suffix>`: milliseconds of the codec decode
(`models/encodec.py::decode`: RVQ decode and SEANet decoder) per request,
from the benchmark's span around the model instance's
`compression_model.decode` (host clock between two synchronises), averaged
over the timed window's requests. Moves `gen_audio_s_per_s`."""


def read(view, suffix):
    done = len(view.window.items)
    ms = getattr(view.state, "codec_ms", [])[:done]
    return sum(ms) / len(ms) if ms else None
