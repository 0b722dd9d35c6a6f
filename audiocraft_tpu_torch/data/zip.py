"""Files inside zip archives, named `<zip path>:<path in the zip>`, read
through a small cache of open archives (counterpart of
`audiocraft_tpu/data/zip.py`)."""
import functools
import typing as tp
import zipfile
from dataclasses import dataclass

DEFAULT_SIZE = 32
MODE = "r"


@dataclass(order=True)
class PathInZip:
    """`<zip_path>:<file_path>`: the archive and the member inside it."""
    INFO_PATH_SEP = ":"
    zip_path: str
    file_path: str

    def __init__(self, path: str) -> None:
        parts = path.split(self.INFO_PATH_SEP)
        assert len(parts) == 2, f"expected <zip>:<file>, got {path!r}"
        self.zip_path, self.file_path = parts

    def __str__(self) -> str:
        return self.zip_path + self.INFO_PATH_SEP + self.file_path

    def __hash__(self):
        return hash(str(self))


def _open_zip_uncached(path: str) -> zipfile.ZipFile:
    return zipfile.ZipFile(path, MODE)


_open_zip = functools.lru_cache(DEFAULT_SIZE)(_open_zip_uncached)


def set_zip_cache_size(max_size: int) -> None:
    """Keep at most `max_size` archives open (the cache starts anew)."""
    global _open_zip
    _open_zip = functools.lru_cache(max_size)(_open_zip_uncached)


def open_file_in_zip(path_in_zip: PathInZip, mode: str = "r") -> tp.IO:
    """A file object for the member, from the archive's cached handle."""
    return _open_zip(path_in_zip.zip_path).open(path_in_zip.file_path)
