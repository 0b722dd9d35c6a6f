"""Objective-metric eval of pretrained MusicGen checkpoints
(`grids/musicgen/musicgen_pretrained_32khz_eval.py`): FAD / KLD / text
consistency / chroma cosine over the eval split, no training."""
from ._explorers import GenerationEvalExplorer


@GenerationEvalExplorer
def explorer(launcher):
    launcher.bind_(solver="musicgen")
    launcher.bind_({"datasource.evaluate": "egs/music/evaluate",
                    "execute_only": "evaluate",
                    "dataset.generate.num_samples": 1000,
                    "evaluate.metrics.fad": True,
                    "evaluate.metrics.kld": True,
                    "evaluate.metrics.text_consistency": True,
                    "evaluate.metrics.chroma_cosine": True})
    launcher.tpu_(chips=8, label="v5e-8")
    with launcher.job_array():
        sub = launcher.bind()
        for name in ("facebook/musicgen-small", "facebook/musicgen-medium",
                     "facebook/musicgen-large", "facebook/musicgen-melody"):
            sub({"continue_from": f"//pretrained/{name}"})
