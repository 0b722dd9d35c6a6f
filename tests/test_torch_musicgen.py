"""The port end to end: the debug MusicGen vs the JAX package's (same
weights, greedy decoding), the entry points' device rule, the import
boundary. The same path on the card is tested in `test_torch_gpu.py`.

Tolerance: tokens equal; waveform atol 1e-4 / rtol 1e-3 (f32 codec decode
of equal codes, deep conv stacks summed in another order)."""
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiocraft_tpu.models import MusicGen as JaxMusicGen
from audiocraft_tpu_torch.models import MusicGen
from audiocraft_tpu_torch.models import builders
from audiocraft_tpu_torch.models.lm import GenParams
from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
from audiocraft_tpu_torch.utils import jax_weights

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "audiocraft_tpu_torch"
TEXTS = ["90s rock song with loud guitars", "calm piano"]


def _port_debug_from_jax(jmg, device="cpu"):
    codec = builders.get_debug_compression_model(device=device)
    jax_weights.load_encodec(codec, jax.tree.map(np.asarray,
                                                 jmg.compression_variables))
    lm = builders.get_debug_lm_model(device=device)
    jax_weights.load_lm(lm, jax.tree.map(np.asarray, jmg.lm_params))
    return MusicGen("debug", codec, lm, max_duration=30, device=device)


def test_debug_musicgen_matches_jax_end_to_end():
    jmg = JaxMusicGen.get_pretrained("debug")
    jmg.set_generation_params(use_sampling=False, duration=0.5)
    jwav, jtok = jmg.generate(TEXTS, return_tokens=True)
    mg = _port_debug_from_jax(jmg)
    mg.set_generation_params(use_sampling=False, duration=0.5)
    wav, tok = mg.generate(TEXTS, return_tokens=True)
    assert tok.shape == (2, 4, 12) and wav.shape == (2, 1, 12 * 1280)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=1e-4,
                               rtol=1e-3)


def test_debug_musicgen_long_window_and_unconditional():
    mg = MusicGen.get_pretrained("debug", device="cpu")
    mg.max_duration = 0.6
    mg.set_generation_params(duration=1.2, extend_stride=0.3, top_k=10)
    wav, tok = mg.generate(["techno"], return_tokens=True)
    assert tok.shape[-1] >= 30 and wav.shape[-1] == tok.shape[-1] * 1280
    mg.set_generation_params(duration=0.2, extend_stride=0.1)
    wav = mg.generate_unconditional(3)
    assert wav.shape == (3, 1, 5 * 1280) and torch.isfinite(wav).all()


@pytest.mark.parametrize("entry", ["get_pretrained", "MusicGen",
                                   "LMModel.generate", "EncodecModel.decode"])
def test_entry_points_without_device_raise_when_no_card(entry, monkeypatch):
    """Without `device=`, entry points run on CUDA; with no card they raise
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = builders.get_debug_lm_model(device="cpu")
    codec = builders.get_debug_compression_model(device="cpu")
    calls = {
        "get_pretrained": lambda: MusicGen.get_pretrained("debug"),
        "MusicGen": lambda: MusicGen("debug", codec, lm),
        "LMModel.generate": lambda: lm.generate(num_samples=1, max_gen_len=4),
        "EncodecModel.decode": lambda: codec.decode(
            torch.zeros(1, 4, 3, dtype=torch.long)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, chip_smoke.py and the port's scripts
    (`scripts/torch_*.py`) import with `jax`, `audiocraft_tpu` and
    `transformers` (absent on the card's machine) blocked, and no source
    names them in an import."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py") + [
        "audiocraft_tpu_torch"]
    scripts = sorted(str(p) for p in (ROOT / "scripts").glob("torch_*.py"))
    assert any(p.endswith("torch_int4_decode.py") for p in scripts)
    assert any(p.endswith("torch_demucs_precision.py") for p in scripts)
    # the melody, AudioGen, training, codec-training, AudioSeal, CLAP,
    # DAC and evaluation slices' modules are among those imported
    assert {f"audiocraft_tpu_torch.{m}" for m in (
        "ops.stft", "modules.chroma", "modules.demucs", "models.audiogen",
        "solvers.audiogen", "solvers.base", "solvers.magnet", "optim.dadam",
        "optim.ema", "utils.checkpoint", "utils.writers", "utils.profiler",
        "utils.deadlock", "environment", "losses.balancer",
        "adversarial.losses", "adversarial.discriminators.msstftd",
        "quantization.base", "metrics.rvm", "solvers.compression",
        "losses.wmloss", "losses.loudnessloss", "utils.audio_effects",
        "solvers.watermark", "modules.clap", "models.dac", "metrics.miou",
        "metrics.fad", "metrics.vggish", "metrics.passt", "metrics.kld",
        "metrics.clap_consistency", "metrics.chroma_cosinesim",
        "metrics.pesq", "metrics.visqol", "grids._base_explorers",
        "grids.__main__", "utils.assets", "utils.notebook")
    } <= set(modules)
    script = (
        "import sys, importlib, importlib.util\n"
        "for name in ('jax', 'jaxlib', 'flax', 'audiocraft_tpu',\n"
        "             'transformers'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f's{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('IMPORTS_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert "IMPORTS_OK" in proc.stdout, proc.stderr[-3000:]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|audiocraft_tpu"
                         r"|transformers)\b(?!_torch)", re.M)
    for path in (list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                 + [Path(p) for p in scripts]):
        assert not pattern.search(path.read_text()), path


def test_generation_counts_forwards_per_pattern_step():
    """Each generation makes one forward per pattern step after the first
    (S - 1 for S pattern slots): the prefill over step 0, then one T=1 step
    per remaining slot. On the card each is one decode-attention launch per
    layer; here the same calls reach the plain version."""
    lm = builders.get_debug_lm_model(device="cpu")
    calls = []
    layer = lm.transformer.layers[0].self_attn
    hook = layer.register_forward_hook(lambda m, a, o: calls.append(a[0].shape[1]))
    try:
        lm.generate(conditions=[ConditioningAttributes(
            text={"description": "techno"})], max_gen_len=20, device="cpu")
    finally:
        hook.remove()
    S = len(lm.pattern_provider.get_pattern(20).layout)
    assert calls == [1] * (S - 1)
