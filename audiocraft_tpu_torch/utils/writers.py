"""Experiment metric writers: TensorBoard (through `tensorboardX`) and
Weights & Biases (counterpart of `audiocraft_tpu/utils/writers.py`).

`logging.log_tensorboard` and `logging.log_wandb` switch each on. Both
backends are optional: when a package is missing the writer warns once and
does nothing.
"""
import logging
import struct
import typing as tp
import warnings
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def wav_bytes(wav, sample_rate: int) -> bytes:
    """[C, T] float samples in [-1, 1] -> a 16-bit PCM WAV file's bytes."""
    wav = np.asarray(wav, np.float32)
    pcm = np.clip(np.round(wav.T * 2 ** 15), -2 ** 15, 2 ** 15 - 1)
    data = pcm.astype("<i2").tobytes()
    channels = wav.shape[0]
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                            sample_rate * channels * 2, channels * 2, 16)
              + b"data" + struct.pack("<I", len(data)))
    return header + data


def _missing(package: str, switch: str) -> None:
    warnings.warn(f"logging.{switch} is set but {package} is not installed; "
                  f"not logging there", stacklevel=3)


class ExperimentWriters:
    """Scalars and audio of one experiment folder, per stage and epoch."""

    def __init__(self, cfg: dict, folder: Path):
        log_cfg = cfg.get("logging", {}) or {}
        self._tb = None
        self._wandb = None
        self.with_media = False
        if log_cfg.get("log_tensorboard"):
            tb_cfg = cfg.get("tensorboard", {}) or {}
            logdir = Path(folder) / (tb_cfg.get("sub_dir") or "tensorboard")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                _missing("tensorboardX", "log_tensorboard")
            else:
                self._tb = SummaryWriter(logdir=str(logdir),
                                         comment=tb_cfg.get("name") or "")
                self.with_media = bool(tb_cfg.get("with_media_logging"))
                logger.info("TensorBoard logging to %s", logdir)
        if log_cfg.get("log_wandb"):
            wb_cfg = cfg.get("wandb", {}) or {}
            try:
                import wandb
            except ImportError:
                _missing("wandb", "log_wandb")
            else:
                self._wandb = wandb.init(
                    project=wb_cfg.get("project"), name=wb_cfg.get("name"),
                    dir=str(folder), config=cfg, resume="allow")
                self.with_media |= bool(wb_cfg.get("with_media_logging"))

    @property
    def active(self) -> bool:
        return self._tb is not None or self._wandb is not None

    def write_scalars(self, stage: str, metrics: tp.Mapping[str, tp.Any],
                      step: int) -> None:
        """Each metric that converts to a float, as `<stage>/<name>` at
        `step` (the epoch)."""
        if not self.active:
            return
        flat = {}
        for key, value in metrics.items():
            try:
                flat[f"{stage}/{key}"] = float(value)
            except (TypeError, ValueError):
                continue
        if self._tb is not None:
            for key, value in flat.items():
                self._tb.add_scalar(key, value, step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(flat, step=step)

    def write_audio(self, tag: str, wav, sample_rate: int, step: int) -> None:
        """A [C, T] (or [T]) waveform as a media entry, when media logging
        is on. The TensorBoard entry is built from WAV bytes, so no audio
        package is needed."""
        if not self.with_media:
            return
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if self._tb is not None:
            from tensorboardX.proto.summary_pb2 import Summary
            audio = Summary.Audio(
                sample_rate=float(sample_rate), num_channels=wav.shape[0],
                length_frames=wav.shape[-1],
                encoded_audio_string=wav_bytes(wav, sample_rate),
                content_type="audio/wav")
            self._tb._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)
            self._tb.flush()
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Audio(wav.T, sample_rate=sample_rate)},
                            step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
