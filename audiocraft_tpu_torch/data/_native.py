"""ctypes binding to the shared native data-plane sources (`native/`).

`native/audio_io.cc` (WAV decode with seek, no dependency) is compiled with
the host C++ compiler at its first use, into a content-hashed library under
the checkout's `build/kernels/` (the directory of the CUDA kernels), and
loaded; a failed build raises with the compiler's output. `native/av_io.cc`
(compressed formats through the system libav) is compiled only when a
compressed format is first asked for; if it cannot be built, that call
raises and WAV is unaffected. Both are built once per process; concurrent
builders (loader workers, parallel tests) each write a temporary file and
move it into place, so a reader never sees half a library.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import typing as tp
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
AV_LIBS = ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_double_p = ctypes.POINTER(ctypes.c_double)
_LOCK = threading.Lock()
_LIBS: tp.Dict[str, ctypes.CDLL] = {}
_FAILED: tp.Dict[str, str] = {}


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)  # type: ignore
    raise RuntimeError("no C++ compiler found (g++, c++ or clang++) to build "
                       "the native audio library")


def library_path(source: str, libs: tp.Sequence[str] = ()) -> Path:
    """Where `native/<source>` compiles to: the digest covers the source and
    the flags, so an edited source is rebuilt."""
    digest = hashlib.sha1((NATIVE_DIR / source).read_bytes())
    digest.update(" ".join((*CXX_FLAGS, *libs)).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def _build(source: str, libs: tp.Sequence[str] = ()) -> Path:
    target = library_path(source, libs)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, str(NATIVE_DIR / source), *libs]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {source} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return target


def _load(source: str, libs: tp.Sequence[str], declare) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            if source in _FAILED:
                raise RuntimeError(_FAILED[source])
            try:
                lib = ctypes.CDLL(str(_build(source, libs)))
            except (RuntimeError, OSError) as exc:
                _FAILED[source] = str(exc)
                raise
            declare(lib)
            _LIBS[source] = lib
    return lib


def _declare_io(lib: ctypes.CDLL) -> None:
    lib.wav_info.argtypes = [ctypes.c_char_p, _c_int_p, _c_int_p, _c_long_p]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                             _c_float_p, ctypes.c_long]
    lib.wav_read.restype = ctypes.c_long
    lib.wav_read_resample.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_int,
                                      ctypes.c_int, _c_float_p, ctypes.c_long]
    lib.wav_read_resample.restype = ctypes.c_long


def _declare_av(lib: ctypes.CDLL) -> None:
    lib.av_audio_info.argtypes = [ctypes.c_char_p, _c_int_p, _c_int_p,
                                  _c_long_p, _c_double_p]
    lib.av_audio_info.restype = ctypes.c_int
    lib.av_audio_read.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                  ctypes.c_double, _c_float_p, ctypes.c_long,
                                  _c_int_p, _c_int_p]
    lib.av_audio_read.restype = ctypes.c_long
    lib.av_audio_write.argtypes = [ctypes.c_char_p, _c_float_p, ctypes.c_long,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.av_audio_write.restype = ctypes.c_int


def io_lib() -> ctypes.CDLL:
    """The WAV library, built first if needed (raises if it cannot be)."""
    return _load("audio_io.cc", (), _declare_io)


def av_lib() -> ctypes.CDLL:
    """The libav wrapper, built first if needed (raises if it cannot be)."""
    return _load("av_io.cc", AV_LIBS, _declare_av)


def available() -> bool:
    """Whether the WAV library builds and loads here."""
    try:
        io_lib()
    except RuntimeError:
        return False
    return True


def av_available() -> bool:
    """Whether the libav wrapper builds and loads here."""
    try:
        av_lib()
    except RuntimeError:
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def wav_info(path: str) -> tp.Tuple[int, int, int]:
    """(sample_rate, channels, num_frames) of a WAV file."""
    sr, ch, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = io_lib().wav_info(str(path).encode(), ctypes.byref(sr),
                           ctypes.byref(ch), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"wav_info failed ({rc}) for {path}")
    return sr.value, ch.value, n.value


def wav_read(path: str, seek_time: float = 0.0, duration: float = -1.0
             ) -> tp.Tuple[np.ndarray, int]:
    """([C, T] f32, sample rate) from `seek_time` for `duration` seconds
    (all of the rest when not positive)."""
    sr, ch, total = wav_info(path)
    start = int(seek_time * sr)
    want = int(duration * sr) if duration > 0 else max(total - start, 0)
    # the library writes channel c at a stride of the capacity it is given
    out = np.empty((ch, max(want, 1)), np.float32)
    got = io_lib().wav_read(str(path).encode(), start, want, _fptr(out),
                            out.shape[1])
    if got < 0:
        raise RuntimeError(f"wav_read failed ({got}) for {path}")
    return out[:, :got].copy(), sr


def wav_read_resample(path: str, seek_time: float, duration: float,
                      target_sr: int, target_channels: int) -> np.ndarray:
    """Decode, resample to `target_sr` and convert to `target_channels` in
    one native pass: [target_channels, frames] f32 from `seek_time` for
    `duration` seconds (all of the rest when not positive)."""
    sr, _, total = wav_info(path)
    want = int(duration * sr) if duration > 0 else total
    cap = int(np.ceil(want * target_sr / sr)) + 16
    out = np.empty((target_channels, cap), np.float32)
    got = io_lib().wav_read_resample(str(path).encode(), float(seek_time),
                                     float(duration), int(target_sr),
                                     int(target_channels), _fptr(out), cap)
    if got < 0:
        raise RuntimeError(f"wav_read_resample failed ({got}) for {path}")
    return out[:, :got].copy()


def av_info(path: str) -> tp.Tuple[int, int, int, float]:
    """(sample_rate, channels, estimated frames, duration in seconds) of any
    file libav demuxes (mp3, ogg, flac, aac, opus, wav)."""
    sr, ch, n, dur = ctypes.c_int(), ctypes.c_int(), ctypes.c_long(), \
        ctypes.c_double()
    rc = av_lib().av_audio_info(str(path).encode(), ctypes.byref(sr),
                                ctypes.byref(ch), ctypes.byref(n),
                                ctypes.byref(dur))
    if rc != 0:
        raise RuntimeError(f"av_audio_info failed ({rc}) for {path}")
    return sr.value, ch.value, n.value, dur.value


def av_read(path: str, seek_time: float = 0.0, duration: float = -1.0
            ) -> tp.Tuple[np.ndarray, int]:
    """Decode a compressed file with sample-accurate seek: ([C, T] f32,
    sample rate)."""
    sr, ch, total, _ = av_info(path)
    if duration > 0:
        cap = int(duration * sr + 0.5) + 1
    else:  # a VBR estimate can fall short: leave a second of room
        cap = max(total - int(seek_time * sr), 0) + sr
    out = np.zeros((max(ch, 1), max(cap, 1)), np.float32)
    out_sr, out_ch = ctypes.c_int(), ctypes.c_int()
    got = av_lib().av_audio_read(str(path).encode(), float(seek_time),
                                 float(duration), _fptr(out), out.shape[1],
                                 ctypes.byref(out_sr), ctypes.byref(out_ch))
    if got < 0:
        raise RuntimeError(f"av_audio_read failed ({got}) for {path}")
    return out[:out_ch.value, :got].copy(), out_sr.value


def av_write(path: str, wav: np.ndarray, sample_rate: int, format: str,
             bitrate_kbps: int = 0) -> None:
    """Encode [C, T] f32 as wav, mp3, ogg, flac, aac or opus."""
    interleaved = np.ascontiguousarray(np.asarray(wav, np.float32).T)
    frames, ch = interleaved.shape
    rc = av_lib().av_audio_write(str(path).encode(), _fptr(interleaved),
                                 frames, ch, int(sample_rate),
                                 format.encode(), int(bitrate_kbps))
    if rc != 0:
        raise RuntimeError(f"av_audio_write failed ({rc}) for {path}")
