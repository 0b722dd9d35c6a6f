"""MusicGen-Style sweep (`grids/musicgen/musicgen_style_32khz.py`): style
bottleneck (RVQ over frozen codec features) prepended, double CFG at eval."""
from .musicgen_base_32khz import scale
from ._explorers import LMExplorer


@LMExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.train": "egs/music/train",
                    "datasource.valid": "egs/music/valid"})
    style = {
        "conditioners.self_wav.model": "style",
        "conditioners.self_wav.style.transformer_scale": "default",
        "conditioners.self_wav.style.ds_factor": 15,
        "conditioners.self_wav.style.n_q_out": 6,
        "conditioners.self_wav.style.eval_q": 3,
        "conditioners.self_wav.style.length": 3.0,
        "fuser.prepend": ["self_wav"],
        "classifier_free_guidance.training_dropout": 0.3,
    }
    launcher.bind_(style, {"fsdp.use": True})

    launcher.tpu_(chips=32, label="v5e-32")
    with launcher.job_array():
        sub = launcher.bind()
        sub(scale("small"))
        sub(scale("small"), {"conditioners.self_wav.style.eval_q": 1})
