"""The safetensors file format, read and written with numpy.

A file is an 8-byte little-endian header length N, N bytes of JSON (each
tensor's `dtype`, `shape` and `data_offsets` [begin, end) into the byte
buffer that follows, plus an optional `__metadata__` of strings, which the
reader skips), then the buffer. The reader takes F64, F32, F16, BF16, I64,
I32, I16, I8, U8 and BOOL and returns CPU tensors (BF16 read as uint16 and
viewed as `torch.bfloat16`); the writer writes tensors of those dtypes. It
checks the layout as the `safetensors` package does:
a header that runs past the file, is not JSON, or names offsets that
overlap, leave a gap, run out of the buffer or disagree with the shape
raises `ValueError`. The port reads Hugging Face snapshots (EnCodec, MERT)
with it, so it needs no `safetensors` package.
"""
import json
import struct
import typing as tp
from pathlib import Path

import numpy as np
import torch

_DTYPES: tp.Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"),
    "BOOL": np.dtype("?")}
_TORCH_NAMES = {torch.float64: "F64", torch.float32: "F32",
                torch.float16: "F16", torch.bfloat16: "BF16",
                torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
                torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_HEADER_LIMIT = 100_000_000  # the safetensors package's own bound


def _parse(data: bytes) -> tp.Tuple[dict, memoryview]:
    if len(data) < 8:
        raise ValueError("safetensors: the file is shorter than its 8-byte "
                         "header length")
    (n,) = struct.unpack("<Q", data[:8])
    if n > _HEADER_LIMIT or 8 + n > len(data):
        raise ValueError(f"safetensors: a header of {n} bytes does not fit "
                         f"a file of {len(data)}")
    try:
        header = json.loads(data[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"safetensors: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError("safetensors: the header is not a JSON object")
    return header, memoryview(data)[8 + n:]


def _entries(header: dict, size: int) -> tp.List[tp.Tuple[str, dict]]:
    """The tensors' entries in buffer order, checked to tile the buffer."""
    entries = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[info["dtype"]]
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"safetensors: bad entry for {name!r}: "
                             f"{info}") from None
        if any(d < 0 for d in shape) or \
                end - begin != int(np.prod(shape)) * dtype.itemsize:
            raise ValueError(f"safetensors: {name!r} spans bytes [{begin}, "
                             f"{end}), not its shape {shape} of "
                             f"{info['dtype']}")
        entries.append((begin, end, name))
    position = 0
    for begin, end, name in sorted(entries):
        if begin != position:
            raise ValueError(f"safetensors: {name!r} starts at byte {begin}, "
                             f"expected {position} (overlap or gap)")
        position = end
    if position != size:
        raise ValueError(f"safetensors: the tensors cover {position} bytes of "
                         f"a {size}-byte buffer")
    return [(name, header[name]) for _, _, name in sorted(entries)]


def load_file(path: tp.Union[str, Path]) -> tp.Dict[str, torch.Tensor]:
    """Every tensor of the file at `path`, as CPU tensors by name."""
    header, buffer = _parse(Path(path).read_bytes())
    out = {}
    for name, info in _entries(header, len(buffer)):
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        arr = np.frombuffer(buffer[begin:end], dtype=dtype).reshape(
            info["shape"]).copy()
        tensor = torch.from_numpy(arr)
        if info["dtype"] == "BF16":
            tensor = tensor.view(torch.int16).view(torch.bfloat16)
        out[name] = tensor
    return out


def save_file(tensors: tp.Mapping[str, torch.Tensor],
              path: tp.Union[str, Path]) -> None:
    """Write tensors (any device) to `path` in name order, the header padded
    with spaces to 8 bytes."""
    header: dict = {}
    chunks, offset = [], 0
    for name in sorted(tensors):
        value = tensors[name].detach().cpu().contiguous()
        if value.dtype not in _TORCH_NAMES:
            raise ValueError(f"safetensors: dtype {value.dtype} is not written")
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        arr = value.numpy()
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _TORCH_NAMES[tensors[name].dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
