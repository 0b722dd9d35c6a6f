"""ViSQOL perceptual quality through its external binary (counterpart of
`audiocraft_tpu/metrics/visqol.py`): the wav pairs and a CSV are written to
a temporary folder, `<bin>/bazel-bin/visqol` runs over them, and the mean
of its `moslqo` column is the result."""
import csv
import logging
import subprocess
import tempfile
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..data.audio import audio_write
from ..ops.resample import resample_frac
from ..utils.utils import host_f32

logger = logging.getLogger(__name__)


class ViSQOL:
    SAMPLE_RATES_MODES = {"audio": 48000, "speech": 16000}
    ALLOWED_SAMPLE_RATES = frozenset(SAMPLE_RATES_MODES.values())

    def __init__(self, bin: tp.Union[Path, str], mode: str = "audio",
                 model: str = "tcdaudio14_aacvopus_coresv_svrnsim_n.68_g.01_c1.model",
                 debug: bool = False):
        assert bin is not None and Path(bin).exists(), \
            f"Could not find ViSQOL binary in specified path: {bin}"
        self.visqol_bin = str(bin)
        self.visqol_mode = mode
        self.target_sr = self._get_target_sr(self.visqol_mode)
        self.model = model
        self.debug = debug
        assert Path(self.visqol_model).exists(), \
            f"Could not find the specified model in ViSQOL install: {self.visqol_model}"

    def _get_target_sr(self, mode: str) -> int:
        if mode not in ViSQOL.SAMPLE_RATES_MODES:
            raise ValueError(
                f"Unsupported mode! Allowed are: {list(ViSQOL.SAMPLE_RATES_MODES.keys())}")
        return ViSQOL.SAMPLE_RATES_MODES[mode]

    @property
    def visqol_model(self):
        return f"{self.visqol_bin}/model/{self.model}"

    def _prepare_files(self, ref_sig, deg_sig, sr: int, target_sr: int,
                       pad_with_silence: bool = False):
        """The resampled wav pairs (clipped, not normalised; 0.5 s of
        silence each side when asked) and the input CSV in a new temporary
        folder. Returns (input csv, results csv)."""
        ref_sig, deg_sig = host_f32(ref_sig), host_f32(deg_sig)
        if target_sr != sr:
            ref_sig = resample_frac(torch.from_numpy(ref_sig), sr,
                                    target_sr).numpy()
            deg_sig = resample_frac(torch.from_numpy(deg_sig), sr,
                                    target_sr).numpy()
        tmp_dir = Path(tempfile.mkdtemp())
        pad = int(0.5 * target_sr) if pad_with_silence else 0
        rows = []
        for i in range(ref_sig.shape[0]):
            ref = np.pad(ref_sig[i], ((0, 0), (pad, pad)))
            deg = np.pad(deg_sig[i], ((0, 0), (pad, pad)))
            ref_path = audio_write(tmp_dir / f"ref_{i}", ref, target_sr,
                                   normalize=False, strategy="clip")
            deg_path = audio_write(tmp_dir / f"deg_{i}", deg, target_sr,
                                   normalize=False, strategy="clip")
            rows.append((str(ref_path), str(deg_path)))
        input_csv = tmp_dir / "input.csv"
        results_csv = tmp_dir / "results.csv"
        with open(input_csv, "w") as f:
            writer = csv.writer(f)
            writer.writerow(["reference", "degraded"])
            writer.writerows(rows)
        return input_csv, results_csv

    def __call__(self, ref_sig, deg_sig, sr: int,
                 pad_with_silence: bool = False) -> float:
        """The mean moslqo over the batch [B, C, T]."""
        input_csv, results_csv = self._prepare_files(
            ref_sig, deg_sig, sr, self.target_sr, pad_with_silence)
        cmd = [f"{self.visqol_bin}/bazel-bin/visqol",
               "--batch_input_csv", str(input_csv),
               "--results_csv", str(results_csv),
               "--similarity_to_quality_model", self.visqol_model]
        if self.visqol_mode == "speech":
            cmd += ["--use_speech_mode"]
        result = subprocess.run(cmd, capture_output=True)
        if result.returncode:
            logger.error("Error with visqol: \n %s \n %s",
                         result.stdout.decode(), result.stderr.decode())
            raise RuntimeError("Error while executing visqol")
        with open(results_csv) as f:
            moslqos = [float(row["moslqo"]) for row in csv.DictReader(f)]
        return float(np.mean(moslqos)) if moslqos else 0.0
