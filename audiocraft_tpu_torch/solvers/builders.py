"""Solver registry, optimizer factory and the loaders of a config's
datasource (counterpart of `audiocraft_tpu/solvers/builders.py`)."""
import logging
import typing as tp
from enum import Enum

import torch
import torch.nn as nn

from ..optim.dadam import DAdaptAdam
from ..optim.lr_schedulers import get_lr_scheduler
from ..parallel import sharding

logger = logging.getLogger(__name__)

ParamGroups = tp.List[tp.Dict[str, tp.Any]]


def get_solver(cfg: dict, device=None):
    """The solver named by `cfg['solver']`: MusicGen, AudioGen, MAGNeT,
    AudioGen-MAGNeT, EnCodec (`compression`), Multi-Band Diffusion
    (`diffusion`), JASCO or AudioSeal (`watermarking`)."""
    from .audiogen import AudioGenSolver
    from .compression import CompressionSolver
    from .diffusion import DiffusionSolver
    from .jasco import JascoSolver
    from .magnet import AudioMagnetSolver, MagnetSolver
    from .musicgen import MusicGenSolver
    from .watermark import WatermarkSolver
    solvers = {"musicgen": MusicGenSolver, "audiogen": AudioGenSolver,
               "magnet": MagnetSolver, "audio_magnet": AudioMagnetSolver,
               "compression": CompressionSolver, "diffusion": DiffusionSolver,
               "jasco": JascoSolver, "watermarking": WatermarkSolver}
    name = cfg["solver"]
    if name not in solvers:
        raise NotImplementedError(f"solver {name!r} is not ported")
    return solvers[name](cfg, device=device)


def compression_model_from_checkpoint(checkpoint: tp.Optional[str], device,
                                      sample_rate: int = 32000):
    """The frozen codec of a solver's `compression_model_checkpoint`: the
    debug codec at `sample_rate` for 'debug' or None, else the codec
    package at that path (or under `AUDIOCRAFT_CACHE_DIR`) through
    `models.loaders.load_compression_model`, as the JAX package's
    `CompressionSolver.model_from_checkpoint`; `//sig/` references are
    not resolved. Evaluation mode, no gradients."""
    from ..models import builders as model_builders
    from ..models import loaders
    if checkpoint in ("debug", None):
        model = model_builders.get_debug_compression_model(
            device=device, sample_rate=sample_rate)
    else:
        model = loaders.load_compression_model(str(checkpoint), device=device)
    return model.eval().requires_grad_(False)


def get_optim_parameter_groups(model: nn.Module,
                               group_overrides: tp.Dict[str, dict]
                               ) -> ParamGroups:
    """The trainable parameters of `model` split by top-level submodule:
    one group per name in `group_overrides` (e.g. 'transformer'), carrying
    its {'lr', 'weight_decay'} overrides, and a 'default' group for the
    rest. Frozen parameters (requires_grad False) join no group."""
    groups: tp.Dict[str, ParamGroups] = {}
    for name, param in model.named_parameters():
        if not param.requires_grad:
            continue
        top = name.split(".", 1)[0]
        label = top if group_overrides.get(top) else "default"
        groups.setdefault(label, []).append(param)
    return [{"params": params, "name": label,
             **(group_overrides.get(label) or {})}
            for label, params in groups.items()]


class ClippedOptimizer:
    """An optimizer step preceded by clipping the gradients' global norm to
    `max_norm` (0: no clipping), with each group's LR schedule stepped after
    the update: optax's `chain(clip_by_global_norm, adamw(schedule))`.
    torch scales by max_norm / (norm + 1e-6) where optax scales by
    max_norm / norm, a relative difference of 1e-6 / norm in clipped steps."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: tp.Sequence[tp.Callable[[int], float]],
                 max_norm: float = 0.0):
        self.optimizer = optimizer
        self.max_norm = max_norm
        lambdas = [lambda step, f=f, lr=g["lr"]: f(step) / lr if lr else 0.0
                   for f, g in zip(schedules, optimizer.param_groups)]
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)

    @property
    def params(self) -> tp.List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, advance the schedule; returns the gradients' global
        norm before clipping (a 0-d tensor, not synchronised)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if sharding.is_sharded(grads):
            norm = sharding.clip_grad_norm_(grads, self.max_norm)
        else:
            norm = torch.nn.utils.get_total_norm(grads)
            if self.max_norm:
                torch.nn.utils.clip_grads_with_norm_(self.params,
                                                     self.max_norm, norm)
        self.optimizer.step()
        self.scheduler.step()
        return norm


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """Zero gradients for the parameters the loss did not reach, so torch's
    optimizer steps them as optax steps every parameter (AdamW's decay)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_torch_optimizer(groups: ParamGroups, name: str, lr: float,
                         betas: tp.Sequence[float], eps: float,
                         weight_decay: float) -> torch.optim.Optimizer:
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    if name == "adam":
        # optax.adam has no weight decay; neither do the groups here
        for g in groups:
            g.pop("weight_decay", None)
        return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=eps)
    if name == "dadam":
        # the adapted step size takes the place of the rate: a multiplier of
        # 1.0 for every group, as the JAX package's `dadapt_adam(1.0, ...)`
        for g in groups:
            g["lr"] = 1.0
        return DAdaptAdam(groups, lr=1.0, betas=tuple(betas), eps=eps,
                          weight_decay=weight_decay)
    raise ValueError(f"Unsupported Optimizer: {name}")


def get_optimizer(params: tp.Union[ParamGroups, tp.Iterable[torch.Tensor]],
                  cfg: dict, total_updates: int = 1) -> ClippedOptimizer:
    """AdamW, Adam or D-Adaptation Adam with clipping and an LR schedule
    from an `optim` config: `optimizer`, `lr`, `adam.{betas, eps,
    weight_decay}`, `max_norm`, and `lr_scheduler` with its settings under
    the scheduler's name (D-Adaptation Adam takes no rate and no schedule,
    as in the JAX package). `params` is
    a list of tensors or of groups from `get_optim_parameter_groups`; a
    group's 'lr' and 'weight_decay' override the config's, and every group
    follows the same schedule shape from its own peak rate."""
    params = list(params)
    groups = (params if params and isinstance(params[0], dict)
              else [{"params": params}])
    base_lr = float(cfg.get("lr", 1e-4))
    adam = cfg.get("adam", {}) or {}
    weight_decay = float(adam.get("weight_decay", 0.0))
    name = cfg.get("optimizer", "adamw")
    sched_name = cfg.get("lr_scheduler") if name != "dadam" else None
    sched_cfg = cfg.get(sched_name or "", {})
    sched_cfg = sched_cfg if isinstance(sched_cfg, dict) else {}
    groups = [{**g, "lr": float(g.get("lr", base_lr)),
               "weight_decay": float(g.get("weight_decay", weight_decay))}
              for g in groups]
    optimizer = make_torch_optimizer(
        groups, name, base_lr,
        adam.get("betas", (0.9, 0.999)), float(adam.get("eps", 1e-8)),
        weight_decay)
    schedules = [get_lr_scheduler(sched_name, g["lr"], total_updates, sched_cfg)
                 for g in optimizer.param_groups]
    return ClippedOptimizer(optimizer, schedules,
                            float(cfg.get("max_norm", 0.0) or 0.0))


class DatasetType(Enum):
    AUDIO = "audio"
    MUSIC = "music"
    SOUND = "sound"


def get_audio_datasets(cfg: dict, dataset_type: DatasetType = DatasetType.AUDIO,
                       device=None) -> tp.Dict[str, "DataLoader"]:
    """A loader per split of `cfg['datasource']` (train, valid, evaluate,
    generate; a manifest file or a folder with `data.jsonl`), over the
    dataset of `dataset_type` at the config's `sample_rate` and `channels`.

    As in the JAX package, a split's dataset takes only `segment_duration`,
    `min_segment_ratio` (default 0.5), `num_samples` (the split's own, else
    10000), `shuffle` (the split's, default True for train only) and
    `return_info` True from `cfg['dataset']`; its other keys (the sampling
    switches, `shuffle_seed`, the music and sound options) are not passed.
    The loader takes the split's `batch_size` (default 1) and
    `num_workers` (default 2) as worker processes, in index order, and pins
    its batches when `device` is a card."""
    from ..data.loader import DataLoader
    from ..data.info_audio_dataset import InfoAudioDataset
    from ..data.music_dataset import MusicDataset
    from ..data.sound_dataset import SoundDataset
    dataset_class = {DatasetType.MUSIC: MusicDataset,
                     DatasetType.SOUND: SoundDataset,
                     DatasetType.AUDIO: InfoAudioDataset}[dataset_type]
    sources = dict(cfg.get("datasource", {}) or {})
    dataset_cfg = dict(cfg.get("dataset", {}) or {})
    sample_rate, channels = cfg["sample_rate"], cfg["channels"]
    assert sources.pop("max_sample_rate", sample_rate) >= sample_rate
    assert sources.pop("max_channels", channels) >= channels
    splits = ("train", "valid", "evaluate", "generate")
    pin = device is not None and torch.device(device).type == "cuda"
    loaders = {}
    for split in splits:
        path = sources.get(split)
        if path is None:
            continue
        own = dataset_cfg.get(split)
        own = own if isinstance(own, dict) else {}
        split_cfg = {k: v for k, v in {**dataset_cfg, **own}.items()
                     if k not in splits}
        num_samples = own.get("num_samples")
        dataset = dataset_class.from_meta(
            path, segment_duration=split_cfg.get("segment_duration"),
            num_samples=10000 if num_samples is None else num_samples,
            sample_rate=sample_rate, channels=channels,
            shuffle=split_cfg.get("shuffle", split == "train"),
            return_info=True,
            min_segment_ratio=split_cfg.get("min_segment_ratio", 0.5))
        loaders[split] = DataLoader(
            dataset, batch_size=split_cfg.get("batch_size", 1), shuffle=False,
            num_workers=split_cfg.get("num_workers", 2),
            seed=cfg.get("seed", 2036), pin_memory=pin)
    return loaders


# ------------------------------------------------- evaluation metric builders

def get_fad(cfg: dict, device=None):
    """The FAD metric of `metrics.fad` on `device`. Always constructible:
    without a VGGish checkpoint it takes the log-mel fallback (its
    `embed_kind` names the key to log under). `model: tf` names upstream's
    TF subprocess, which is not used: it warns and takes VGGish from
    `vggish.model_path`."""
    from .. import metrics
    model = cfg.get("model", "vggish")
    if model == "tf":
        logger.warning(
            "metrics.fad.model=tf: the TF FAD subprocess is replaced by "
            "VGGish; set metrics.fad.vggish.model_path to a torch-layout "
            "vggish.pth")
        model = "vggish"
    sub = dict(cfg.get(model) or {})
    return metrics.FrechetAudioDistanceMetric(
        model_path=sub.get("model_path"), device=device)


def get_kldiv(cfg: dict, device=None):
    """The PaSST KLD metric of `metrics.kld` on `device`, or None when no
    PaSST checkpoint is found ($PASST_CHECKPOINT or the cache dir, as in
    the JAX package: the config names none)."""
    from .. import metrics
    model = cfg.get("model", "passt")
    assert model == "passt", f"unsupported kld model: {model}"
    sub = dict(cfg.get(model) or {})
    metric = metrics.PasstKLDivergenceMetric(
        pretrained_length=sub.get("pretrained_length"), device=device)
    return metric if metric.classifier_fn is not None else None


def get_text_consistency(cfg: dict, device=None):
    """The CLAP text-consistency metric of `metrics.text_consistency` on
    `device`, or None without a CLAP checkpoint and its tokenizer files."""
    from .. import metrics
    model = cfg.get("model", "clap")
    assert model == "clap", f"unsupported text consistency model: {model}"
    sub = dict(cfg.get(model) or {})
    metric = metrics.CLAPTextConsistencyMetric(
        model_path=sub.get("model_path"),
        model_arch=sub.get("model_arch", "HTSAT-base"),
        enable_fusion=bool(sub.get("enable_fusion", False)), device=device)
    return metric if metric.embed_audio_fn is not None else None


def get_chroma_cosine_similarity(cfg: dict, device=None):
    """The chroma cosine similarity of `metrics.chroma_cosine` on
    `device`."""
    from .. import metrics
    assert cfg.get("model", "chroma_base") == "chroma_base", \
        "Only 'chroma_base' supported for chroma cosine similarity"
    sub = dict(cfg.get("chroma_base") or {})
    return metrics.ChromaCosineSimilarityMetric(
        sample_rate=int(sub.get("sample_rate") or 32000),
        n_chroma=int(sub.get("n_chroma", 12)),
        radix2_exp=int(sub.get("radix2_exp", 12)),
        argmax=bool(sub.get("argmax", True)), device=device)
