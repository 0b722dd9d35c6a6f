"""Where experiments and reference files live (the part of
`audiocraft_tpu/environment.py` that checkpoint resolution needs).

- `$AUDIOCRAFT_DORA_DIR`: the experiments' root; a `//sig/<sig>` source
  names `<root>/xps/<sig>`. Default: `audiocraft_tpu_torch` under the
  temporary directory (`$TMPDIR`).
- `$AUDIOCRAFT_REFERENCE_DIR`: what a `//reference/...` path starts with.
  Default: the temporary directory.
"""
import os
import re
import tempfile
import typing as tp
from pathlib import Path


def get_dora_dir() -> Path:
    return Path(os.getenv("AUDIOCRAFT_DORA_DIR",
                          Path(tempfile.gettempdir()) / "audiocraft_tpu_torch"))


def get_reference_dir() -> Path:
    return Path(os.getenv("AUDIOCRAFT_REFERENCE_DIR", tempfile.gettempdir()))


def resolve_reference_path(path: tp.Union[str, Path]) -> Path:
    """`//reference/x` -> `<reference dir>/x`; other paths as they are."""
    path = str(path)
    if path.startswith("//reference"):
        reference_dir = get_reference_dir()
        if not reference_dir.exists():
            raise FileNotFoundError(f"reference directory {reference_dir} "
                                    f"does not exist")
        path = re.sub("^//reference", str(reference_dir), path)
    return Path(path)
