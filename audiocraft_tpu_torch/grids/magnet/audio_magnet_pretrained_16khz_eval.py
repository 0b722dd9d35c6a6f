"""Eval of pretrained Audio-MAGNeT checkpoints
(`grids/magnet/audio_magnet_pretrained_16khz_eval.py`)."""
from ..musicgen._explorers import GenerationEvalExplorer


@GenerationEvalExplorer
def explorer(launcher):
    launcher.bind_(solver="audio_magnet")
    launcher.bind_({"datasource.evaluate": "egs/sound/evaluate",
                    "execute_only": "evaluate",
                    "evaluate.metrics.fad": True,
                    "evaluate.metrics.kld": True})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        for name in ("facebook/audio-magnet-small", "facebook/audio-magnet-medium"):
            sub({"continue_from": f"//pretrained/{name}"})
