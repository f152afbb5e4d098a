"""The safetensors format, read without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, then N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``, the offsets
relative to the end of the header, and an optional ``__metadata__`` of
strings), then the tensors' raw little-endian bytes, laid end to end with no
gap. :func:`read_safetensors` reads the file into memory once and returns
tensors that are views of that one buffer (``torch.frombuffer``), so a 1 GB
checkpoint costs 1 GB until its tensors are copied into a model.

:func:`read_torch_weights` is the JAX ``_read_torch_weights``: a
checkpoint directory's ``model.safetensors``, else every
``pytorch_model*.bin`` in sorted order (``torch.load`` with
``weights_only=True``), else ``FileNotFoundError``. There is no sharded
safetensors index, as there is none in the JAX loader.
"""

from __future__ import annotations

import json
import math
import struct
import sys
from pathlib import Path
from typing import Union

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, on the CPU in the file's dtypes.
    Raises ``ValueError`` for a truncated file, an unknown dtype, or a header
    whose tensors overlap, leave a gap, overrun the data or disagree with
    their shape."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors holds little-endian data; this host is big-endian")
    path = Path(path)
    with open(path, "rb") as f:
        buf = bytearray(path.stat().st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, not a safetensors file")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: a header of {n} bytes overruns the file of {len(buf)}")
    try:
        header = json.loads(bytes(buf[8:8 + n]))
    except ValueError as err:
        raise ValueError(f"{path}: header is not JSON ({err})") from None
    header.pop("__metadata__", None)
    start, size = 8 + n, len(buf) - 8 - n

    entries = []
    for name, info in header.items():
        if info.get("dtype") not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info.get('dtype')!r}")
        dtype = DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != math.prod(shape) * itemsize:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, its shape {shape} {info['dtype']} "
                             f"needs {math.prod(shape) * itemsize}")
        entries.append((begin, end, name, dtype, shape, itemsize))
    entries.sort()
    at = 0
    for begin, end, name, *_ in entries:
        if begin != at:
            raise ValueError(f"{path}: {name} begins at byte {begin} of the data, not at {at}: "
                             + ("an overlap" if begin < at else "a gap"))
        at = end
    if at != size:
        raise ValueError(f"{path}: the header covers {at} bytes of data, the file holds {size}")

    tensors = {}
    for begin, end, name, dtype, shape, itemsize in entries:
        count = (end - begin) // itemsize
        if count == 0:  # frombuffer takes no empty range
            tensors[name] = torch.empty(shape, dtype=dtype)
        else:
            tensors[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=start + begin).reshape(shape)
    return tensors


def read_torch_weights(directory: Union[str, Path]) -> dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory: ``model.safetensors``,
    else the ``pytorch_model*.bin`` files merged in sorted order."""
    directory = Path(directory)
    st = directory / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bins = sorted(directory.glob("pytorch_model*.bin"))
    if bins:
        sd = {}
        for b in bins:
            sd.update(torch.load(b, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"no model weights found in {directory}")
