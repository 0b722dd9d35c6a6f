"""The kernel build's library digest (`ops/_build.py`): it covers the source,
every shared header `csrc/*.cuh` and the flags, so an edited header never
loads a stale library. Nothing is compiled here."""
import shutil

import pytest

from audiocraft_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_is_the_same_for_the_same_files(csrc, name):
    assert _build.library_path(name, csrc) == _build.library_path(name)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_changes_with_a_new_header(csrc, name):
    before = _build.library_path(name, csrc)
    (csrc / "extra_common.cuh").write_text("#pragma once\n")
    assert _build.library_path(name, csrc) != before


@pytest.mark.parametrize("name", ["decode_attention", "int4_decode_attention"])
def test_library_path_changes_with_an_edited_header(csrc, name):
    before = _build.library_path(name, csrc)
    header = csrc / "decode_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc) != before


def test_library_path_changes_with_the_source(csrc):
    before = _build.library_path("decode_attention", csrc)
    src = csrc / "decode_attention.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("decode_attention", csrc) != before
