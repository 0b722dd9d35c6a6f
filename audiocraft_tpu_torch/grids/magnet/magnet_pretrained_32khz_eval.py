"""Eval of pretrained MAGNeT music checkpoints
(`grids/magnet/magnet_pretrained_32khz_eval.py`)."""
from ..musicgen._explorers import GenerationEvalExplorer


@GenerationEvalExplorer
def explorer(launcher):
    launcher.bind_(solver="magnet")
    launcher.bind_({"datasource.evaluate": "egs/music/evaluate",
                    "execute_only": "evaluate",
                    "evaluate.metrics.fad": True,
                    "evaluate.metrics.kld": True,
                    "evaluate.metrics.text_consistency": True})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        for name in ("facebook/magnet-small-10secs", "facebook/magnet-medium-10secs",
                     "facebook/magnet-small-30secs", "facebook/magnet-medium-30secs"):
            sub({"continue_from": f"//pretrained/{name}"})
