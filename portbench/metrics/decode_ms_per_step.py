"""`decode_ms_per_step.<suffix>`: device milliseconds per replayed LM
decode step (`models/lm.py::generate`), from the CUDA events that
`models.lm.decode_graph_stats` records around each request's graph
replays, averaged over the timed window's requests. Moves the cell's
serving metric (`gen_audio_s_per_s` or `request_s`)."""


def read(view, suffix):
    done = len(view.window.items)
    ms = getattr(view.state, "replay_ms", [])[:done]
    return sum(ms) / len(ms) if ms else None
