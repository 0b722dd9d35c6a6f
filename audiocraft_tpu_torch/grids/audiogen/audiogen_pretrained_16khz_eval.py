"""Objective-metric eval of pretrained AudioGen
(`grids/audiogen/audiogen_pretrained_16khz_eval.py`)."""
from ..musicgen._explorers import GenerationEvalExplorer


@GenerationEvalExplorer
def explorer(launcher):
    launcher.bind_(solver="audiogen")
    launcher.bind_({"datasource.evaluate": "egs/sound/evaluate",
                    "execute_only": "evaluate",
                    "evaluate.metrics.fad": True,
                    "evaluate.metrics.kld": True,
                    "evaluate.metrics.text_consistency": True})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        launcher.bind()({"continue_from": "//pretrained/facebook/audiogen-medium"})
