"""Generated samples of an experiment, stored with their metadata
(counterpart of `audiocraft_tpu/utils/samples/manager.py`).

Samples live under `<xp folder>/<generate.path, default 'samples'>/
<epoch>/<id>.<ext>` with a JSON sidecar each; prompts under
`<epoch>/prompt/` and references under `reference/`. A sample's id is the
SHA-1 of its index, its prompt's f32 bytes and its conditions (as sorted
JSON), followed by a readable label; a prompt's or reference's id is the
SHA-1 of its f32 bytes (or the sample's id with
`map_reference_to_sample_id`). The same audio gets the same ids and files
as in the JAX package. An unprompted, unconditioned sample gets a random
id. Audio is written through `data.audio.audio_write` with the config's
`generate.audio` settings.
"""
import dataclasses
import hashlib
import json
import logging
import re
import typing as tp
import unicodedata
import uuid
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

import numpy as np

from ...data.audio import audio_read, audio_write

logger = logging.getLogger(__name__)


def _host(wav) -> np.ndarray:
    """An f32 numpy copy of a tensor or array."""
    if hasattr(wav, "detach"):
        wav = wav.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(wav, np.float32))


@dataclasses.dataclass
class ReferenceSample:
    id: str
    path: str
    duration: float


@dataclasses.dataclass
class Sample:
    id: str
    path: str
    epoch: int
    duration: float
    conditioning: tp.Optional[tp.Dict[str, tp.Any]]
    prompt: tp.Optional[ReferenceSample]
    reference: tp.Optional[ReferenceSample]
    generation_args: tp.Optional[tp.Dict[str, tp.Any]]

    def __hash__(self):
        return hash(self.id)

    def audio(self):
        return audio_read(self.path)

    def audio_prompt(self):
        return None if self.prompt is None else audio_read(self.prompt.path)

    def audio_reference(self):
        return (None if self.reference is None
                else audio_read(self.reference.path))


class SampleManager:
    """The samples of an experiment `xp` (anything with `folder` and a
    config dict `cfg`); the ones already on disk are loaded."""

    def __init__(self, xp, map_reference_to_sample_id: bool = False):
        self.xp = xp
        cfg = xp.cfg if isinstance(xp.cfg, dict) else {}
        gen_cfg = cfg.get("generate", {}) or {}
        self.base_folder = Path(xp.folder) / gen_cfg.get("path", "samples")
        self.reference_folder = self.base_folder / "reference"
        self.map_reference_to_sample_id = map_reference_to_sample_id
        self.audio_cfg = gen_cfg.get("audio", {}) or {}
        self.sample_rate = cfg.get("sample_rate", 16000)
        self.samples: tp.List[Sample] = []
        self._load_samples()

    @property
    def latest_epoch(self) -> int:
        return max((s.epoch for s in self.samples), default=0)

    def _load_samples(self) -> None:
        with ThreadPoolExecutor(6) as pool:
            self.samples = list(pool.map(self._load_sample,
                                         self.base_folder.glob("**/*.json")))

    @staticmethod
    @lru_cache(2 ** 16)
    def _load_sample(json_file: Path) -> Sample:
        data = json.loads(Path(json_file).read_text())

        def reference(key):
            return ReferenceSample(**data[key]) if data.get(key) else None

        return Sample(id=data["id"], path=data["path"], epoch=data["epoch"],
                      duration=data["duration"],
                      conditioning=data.get("conditioning"),
                      prompt=reference("prompt"),
                      reference=reference("reference"),
                      generation_args=data.get("generation_args"))

    def _get_tensor_id(self, wav) -> str:
        return hashlib.sha1(_host(wav)).hexdigest()

    def _get_sample_id(self, index: int, prompt_wav, conditions) -> str:
        if prompt_wav is None and not conditions:
            return f"noinput_{uuid.uuid4().hex}"
        digest = hashlib.sha1(f"{index}".encode())
        label = ""
        if prompt_wav is not None:
            digest.update(_host(prompt_wav))
            label += "_prompted"
        else:
            label += "_unprompted"
        if conditions:
            digest.update(json.dumps(conditions, sort_keys=True).encode())
            text = "-".join(f"{key}={slugify(value)}"
                            for key, value in sorted(conditions.items()))
            label += f"_{text[:100] or 'unconditioned'}"
        else:
            label += "_unconditioned"
        return digest.hexdigest() + label

    def _store_audio(self, wav, stem_path: Path,
                     overwrite: bool = False) -> Path:
        """Write the audio unless a file of that stem exists (or
        `overwrite`); its path."""
        existing = [p for p in stem_path.parent.glob(stem_path.stem + ".*")
                    if p.suffix != ".json"]
        if existing and not overwrite:
            return existing[0]
        return audio_write(stem_path, _host(wav), self.sample_rate,
                           **self.audio_cfg)

    def _reference(self, wav, sample_id: str, stem_folder: Path
                   ) -> ReferenceSample:
        ref_id = (sample_id if self.map_reference_to_sample_id
                  else self._get_tensor_id(wav))
        path = self._store_audio(wav, stem_folder / ref_id)
        return ReferenceSample(ref_id, str(path),
                               _host(wav).shape[-1] / self.sample_rate)

    def add_sample(self, sample_wav, epoch: int, index: int = 0,
                   conditions: tp.Optional[tp.Dict[str, str]] = None,
                   prompt_wav=None, ground_truth_wav=None,
                   generation_args: tp.Optional[dict] = None) -> Sample:
        """Store one sample ([C, T]) with its prompt and reference, and its
        JSON sidecar."""
        sample_id = self._get_sample_id(index, prompt_wav, conditions)
        prompt = (None if prompt_wav is None else self._reference(
            prompt_wav, sample_id, self.base_folder / str(epoch) / "prompt"))
        reference = (None if ground_truth_wav is None else self._reference(
            ground_truth_wav, sample_id, self.reference_folder))
        path = self._store_audio(sample_wav,
                                 self.base_folder / str(epoch) / sample_id,
                                 overwrite=True)
        sample = Sample(sample_id, str(path), epoch,
                        _host(sample_wav).shape[-1] / self.sample_rate,
                        conditions, prompt, reference, generation_args)
        self.samples.append(sample)
        with open(path.with_suffix(".json"), "w") as f:
            json.dump(dataclasses.asdict(sample), f, indent=2)
        return sample

    def add_samples(self, samples_wavs, epoch: int,
                    conditioning: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
                    prompt_wavs=None, ground_truth_wavs=None,
                    generation_args: tp.Optional[dict] = None
                    ) -> tp.List[Sample]:
        """`add_sample` for each row of a batch [B, C, T]."""
        def row(batch, i):
            return None if batch is None else batch[i]

        return [self.add_sample(wav, epoch, i, row(conditioning, i),
                                row(prompt_wavs, i),
                                row(ground_truth_wavs, i), generation_args)
                for i, wav in enumerate(samples_wavs)]

    def get_samples(self, epoch: int = -1, max_epoch: int = -1,
                    exclude_prompted: bool = False,
                    exclude_unprompted: bool = False,
                    exclude_conditioned: bool = False,
                    exclude_unconditioned: bool = False) -> tp.Set[Sample]:
        """The samples of one epoch (`epoch`, else the latest at or before
        `max_epoch`, else the latest), filtered."""
        if max_epoch >= 0:
            chosen = max(s.epoch for s in self.samples if s.epoch <= max_epoch)
        else:
            chosen = self.latest_epoch if epoch < 0 else epoch
        return {s for s in self.samples
                if s.epoch == chosen
                and not (exclude_prompted and s.prompt is not None)
                and not (exclude_unprompted and s.prompt is None)
                and not (exclude_conditioned and s.conditioning)
                and not (exclude_unconditioned and not s.conditioning)}


def slugify(value: tp.Any, allow_unicode: bool = False) -> str:
    """A file-name-safe form: ASCII (unless `allow_unicode`), lower-case,
    word characters, spaces and hyphens as single hyphens."""
    value = str(value)
    if allow_unicode:
        value = unicodedata.normalize("NFKC", value)
    else:
        value = (unicodedata.normalize("NFKD", value)
                 .encode("ascii", "ignore").decode("ascii"))
    value = re.sub(r"[^\w\s-]", "", value.lower())
    return re.sub(r"[-\s]+", "-", value).strip("-_")


def _match_stable_samples(samples_per_xp: tp.List[tp.Set[Sample]]
                          ) -> tp.Dict[str, tp.List[Sample]]:
    """Prompted or conditioned samples by id, where every xp has it."""
    by_id = [{s.id: s for s in samples if s.prompt is not None
              or s.conditioning} for samples in samples_per_xp]
    ids = set().union(*(d.keys() for d in by_id))
    return {i: [d[i] for d in by_id] for i in ids
            if all(i in d for d in by_id)}


def _match_unstable_samples(samples_per_xp: tp.List[tp.Set[Sample]]
                            ) -> tp.Dict[str, tp.List[Sample]]:
    """The other samples, paired in order of id across the xps."""
    free = [sorted((s for s in samples if s.prompt is None
                    and not s.conditioning), key=lambda s: s.id)
            for samples in samples_per_xp]
    n = min(len(f) for f in free)
    return {f"noinput_{i}": [f[i] for f in free] for i in range(n)}


def get_samples_for_xps(xps: tp.List, **kwargs
                        ) -> tp.Dict[str, tp.List[Sample]]:
    """The samples of several xps matched to one another."""
    samples_per_xp = [SampleManager(xp).get_samples(**kwargs) for xp in xps]
    return dict(_match_stable_samples(samples_per_xp),
                **_match_unstable_samples(samples_per_xp))
