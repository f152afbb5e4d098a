"""The subset of MessagePack that ``flax.serialization.to_bytes`` writes, read
and written in pure Python, so a native checkpoint's ``params.msgpack`` loads
where the ``msgpack`` package is not installed.

The subset: maps with string keys; arrays (the shape inside an array
payload); str, bin, int, float, bool and nil; ext type 1, an ndarray packed as
``(shape, dtype name, C-order bytes)``, and ext type 3, a numpy scalar packed
the same way. :func:`packb` chooses each encoding as ``msgpack.packb`` does
(the smallest that holds the value, float64 for floats), so a tree written
here is byte for byte what flax writes.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


def _array_from_payload(payload: bytes, scalar: bool):
    shape, dtype_name, buffer = unpackb(payload)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array of dtype {name!r}: numpy has no such dtype") from None
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape)
    return arr[()] if scalar else arr


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack map key {key!r} is not a string")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.sint(1)
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _array_from_payload(payload, scalar=code == EXT_NPSCALAR)

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data: bytes):
    """One msgpack object of the subset -> Python values, numpy arrays for
    ext types 1 and 3. Raises on anything outside the subset or on trailing
    bytes."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return value


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, size in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if n < 1 << (8 * size):
                return bytes([code]) + n.to_bytes(size, "big")
    else:
        for code, size in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if n >= -(1 << (8 * size - 1)):
                return bytes([code]) + n.to_bytes(size, "big", signed=True)
    raise ValueError(f"integer {n} does not fit 64 bits")


def _sized(n: int, small: int | None, codes: tuple[int, ...], sizes: tuple[int, ...]) -> bytes:
    """The header of a str, bin, array or map of length n: the fix form below
    ``small``, else the first code whose length field holds n."""
    if small is not None and n < small:
        return b""
    for code, size in zip(codes, sizes):
        if n < 1 << (8 * size):
            return bytes([code]) + n.to_bytes(size, "big")
    raise ValueError(f"length {n} does not fit msgpack")


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _sized(n, None, (0xC7, 0xC8, 0xC9), (1, 2, 4))
    return head + struct.pack(">b", code) + payload


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(value, out: list) -> None:
    if value is None:
        out.append(b"\xc0")
    elif value is True or value is False:
        out.append(b"\xc3" if value else b"\xc2")
    elif isinstance(value, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _array_payload(value)))
    elif isinstance(value, np.generic):
        out.append(_ext(EXT_NPSCALAR, _array_payload(np.asarray(value))))
    elif isinstance(value, int):
        out.append(_int(value))
    elif isinstance(value, float):
        out.append(b"\xcb" + struct.pack(">d", value))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        head = _sized(len(raw), 32, (0xD9, 0xDA, 0xDB), (1, 2, 4)) or bytes([0xA0 | len(raw)])
        out.append(head + raw)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out.append(_sized(len(raw), None, (0xC4, 0xC5, 0xC6), (1, 2, 4)) + raw)
    elif isinstance(value, (list, tuple)):
        out.append(_sized(len(value), 16, (0xDC, 0xDD), (2, 4)) or bytes([0x90 | len(value)]))
        for item in value:
            _pack(item, out)
    elif isinstance(value, dict):
        out.append(_sized(len(value), 16, (0xDE, 0xDF), (2, 4)) or bytes([0x80 | len(value)]))
        for key, item in value.items():
            if not isinstance(key, str):
                raise ValueError(f"msgpack map key {key!r} is not a string")
            _pack(key, out)
            _pack(item, out)
    else:
        raise ValueError(f"cannot pack a {type(value).__name__} into msgpack")


def packb(value) -> bytes:
    """Python values and numpy arrays of the subset -> msgpack bytes."""
    out: list = []
    _pack(value, out)
    return b"".join(out)
