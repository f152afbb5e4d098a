"""A parquet reader in numpy and the standard library, so the ``mmrs`` and
``web`` datasets load where pandas and pyarrow are not installed.

    columns, index = read_table(path)      # {name: ndarray}, the pandas index
    row = table_row(columns, i)            # what ``df.iloc[i].to_dict()`` gives

What it reads: the footer's ``FileMetaData`` and each page header, decoded
with a Thrift compact-protocol decoder; ``DATA_PAGE``, ``DATA_PAGE_V2`` and
``DICTIONARY_PAGE`` over any number of row groups and pages; the ``PLAIN``,
``PLAIN_DICTIONARY`` / ``RLE_DICTIONARY`` and ``RLE`` encodings (the
RLE/bit-packed hybrid for levels, dictionary indices and booleans);
``UNCOMPRESSED``, ``SNAPPY`` (decoded here) and ``GZIP`` (``zlib``) pages.
Any other encoding or codec raises ``ValueError`` naming it, the column and
the file: Python's standard library has no ZSTD, LZ4 or Brotli decoder.

Each column comes out as ``pandas.read_parquet`` (numpy dtypes) gives it:
integers stay integers unless a null makes them float64 with NaN, floats
hold NaN for null, booleans with a null are objects with None, a top-level
string column holds NaN for null (pandas' ``str`` dtype), binary None;
``Timestamp`` columns are ``datetime64`` in their stored unit (INT96 in ns;
a UTC-adjusted one as naive UTC), ``Date`` ``datetime.date`` objects;
``List`` (the three-level form and the legacy two-level one) an ndarray per
row and a group a dict per row, None where null. The pandas index comes from
the ``pandas`` key-value metadata: a RangeIndex, or stored index columns,
which leave the columns as they do in pandas.
"""

from __future__ import annotations

import gzip
import json
import struct
from pathlib import Path

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift enums
TYPES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD", "LZ4_RAW")
ENCODINGS = {0: "PLAIN", 1: "GROUP_VAR_INT", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
CONVERTED = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL", "DATE", "TIME_MILLIS", "TIME_MICROS",
             "TIMESTAMP_MILLIS", "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32", "UINT_64", "INT_8", "INT_16",
             "INT_32", "INT_64", "JSON", "BSON", "INTERVAL")
LOGICAL = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL", 6: "DATE", 7: "TIME", 8: "TIMESTAMP",
           10: "INTEGER", 11: "UNKNOWN", 12: "JSON", 13: "BSON", 14: "UUID", 15: "FLOAT16"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
JULIAN_EPOCH = 2_440_588  # the Julian day of 1970-01-01, INT96's day count
FIXED = {"INT32": "<i4", "INT64": "<i8", "FLOAT": "<f4", "DOUBLE": "<f8"}


# --- Thrift compact protocol ---------------------------------------------------------------------------------------

def _varint(buf, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class _Compact:
    """Decodes a compact-protocol struct into ``{field id: value}`` (nested
    structs likewise, lists as lists, binary as bytes)."""

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            byte = self.buf[self.pos]
            self.pos += 1
            if byte == 0:
                return out
            kind, delta = byte & 0x0F, byte >> 4
            if delta:
                last += delta
            else:
                n, self.pos = _varint(self.buf, self.pos)
                last = _zigzag(n)
            if kind in (1, 2):  # a bool field carries its value in its type
                out[last] = kind == 1
            else:
                out[last] = self.value(kind)

    def value(self, kind: int):
        if kind in (3, 4, 5, 6):  # byte, i16, i32, i64
            if kind == 3:
                self.pos += 1
                return struct.unpack_from("<b", self.buf, self.pos - 1)[0]
            n, self.pos = _varint(self.buf, self.pos)
            return _zigzag(n)
        if kind == 7:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if kind == 8:
            n, self.pos = _varint(self.buf, self.pos)
            self.pos += n
            return bytes(self.buf[self.pos - n:self.pos])
        if kind in (9, 10):  # list, set
            header = self.buf[self.pos]
            self.pos += 1
            size, elem = header >> 4, header & 0x0F
            if size == 15:
                size, self.pos = _varint(self.buf, self.pos)
            if elem in (1, 2):  # bools in a container take a byte each
                self.pos += size
                return [b == 1 for b in self.buf[self.pos - size:self.pos]]
            return [self.value(elem) for _ in range(size)]
        if kind == 12:
            return self.struct()
        raise ValueError(f"thrift compact type {kind}: not one that parquet's metadata holds")


# --- the schema ----------------------------------------------------------------------------------------------------

class _Node:
    """A schema element, with the definition and repetition levels its
    values reach."""

    def __init__(self, element: dict, parent: "_Node | None"):
        self.name = element.get(4, b"").decode("utf-8")
        self.repetition = element.get(3, REQUIRED)
        self.ptype = TYPES[element[1]] if 1 in element else None
        self.type_length = element.get(2, 0)
        self.converted = CONVERTED[element[6]] if 6 in element else None
        logical = element.get(10) or {}
        self.logical = next(((LOGICAL.get(k, str(k)), v) for k, v in logical.items()), (None, None))
        self.children: list[_Node] = []
        self.parent = parent
        if parent is None:  # the root: no level of its own
            self.path, self.max_def, self.max_rep = (), 0, 0
        else:
            self.path = (*parent.path, self.name)
            self.max_def = parent.max_def + (self.repetition != REQUIRED)
            self.max_rep = parent.max_rep + (self.repetition == REPEATED)

    @property
    def dotted(self) -> str:
        return ".".join(self.path)

    def leaves(self) -> list["_Node"]:
        return [self] if self.ptype is not None else [leaf for c in self.children for leaf in c.leaves()]

    def is_list(self) -> bool:
        return self.converted == "LIST" or self.logical[0] == "LIST"


def _schema(elements: list[dict]) -> _Node:
    root = _Node(elements[0], None)
    pos = 1

    def fill(node: _Node, count: int) -> None:
        nonlocal pos
        for _ in range(count):
            child = _Node(elements[pos], node)
            pos += 1
            node.children.append(child)
            fill(child, elements[pos - 1].get(5, 0))

    fill(root, elements[0].get(5, 0))
    return root


# --- codecs and encodings ------------------------------------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """Snappy's block format: a varint length, then literals and back-copies."""
    data = memoryview(data)
    size, pos = _varint(data, 0)
    out = bytearray(size)
    o, end = 0, len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                width = n - 59
                n = int.from_bytes(data[pos:pos + width], "little")
                pos += width
            n += 1
            out[o:o + n] = data[pos:pos + n]
            pos += n
            o += n
            continue
        if kind == 1:
            n, offset = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            n, offset = (tag >> 2) + 1, data[pos] | (data[pos + 1] << 8)
            pos += 2
        else:
            n, offset = (tag >> 2) + 1, int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if not 0 < offset <= o:
            raise ValueError(f"snappy: a copy at offset {offset} from byte {o}")
        start = o - offset
        if offset >= n:
            out[o:o + n] = out[start:start + n]
        else:  # the copy overlaps what it writes: the last ``offset`` bytes repeat
            out[o:o + n] = (bytes(out[start:o]) * (n // offset + 1))[:n]
        o += n
    if o != size:
        raise ValueError(f"snappy: {o} bytes decoded, {size} announced")
    return bytes(out)


def _decompress(data, codec: str, where: str) -> bytes:
    if codec == "UNCOMPRESSED":
        return bytes(data)
    if codec == "SNAPPY":
        return snappy_decompress(data)
    if codec == "GZIP":
        return gzip.decompress(bytes(data))
    raise ValueError(f"{where}: codec {codec} is not supported (Python's standard library has no decoder for it; "
                     "write the file with SNAPPY, GZIP or no compression)")


def _unpack_bits(data, width: int, count: int) -> np.ndarray:
    """``count`` little-endian ``width``-bit values packed LSB first."""
    if width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")[:count * width]
    return bits.reshape(count, width).astype(np.int64) @ (np.int64(1) << np.arange(width, dtype=np.int64))


def _decode_hybrid(buf, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """The RLE / bit-packed hybrid: ``count`` values of ``width`` bits from
    ``buf[pos:end]``, each run copied or unpacked as a whole."""
    out = np.zeros(count, np.int64)
    filled, value_bytes = 0, (width + 7) // 8
    while filled < count and pos < end:
        header, pos = _varint(buf, pos)
        if header & 1:
            n = (header >> 1) * 8
            nbytes = (header >> 1) * width
            take = min(n, count - filled)
            out[filled:filled + take] = _unpack_bits(buf[pos:pos + nbytes], width, n)[:take]
            pos += nbytes
        else:
            n = header >> 1
            take = min(n, count - filled)
            out[filled:filled + take] = int.from_bytes(buf[pos:pos + value_bytes], "little")
            pos += value_bytes
        filled += take
    if filled < count:
        raise ValueError(f"RLE/bit-packed data ends after {filled} of {count} values")
    return out


def _plain(data, ptype: str, count: int, type_length: int):
    """``count`` PLAIN values: an ndarray for fixed widths, an object array
    of bytes for byte arrays."""
    if ptype in FIXED:
        return np.frombuffer(data, FIXED[ptype], count).astype(FIXED[ptype][1:])
    if ptype == "BOOLEAN":
        return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")[:count].astype(bool)
    if ptype == "INT96":  # nanoseconds of the day, then the Julian day
        raw = np.frombuffer(data, np.uint8, count * 12).reshape(count, 12)
        nanos = raw[:, :8].copy().view("<i8")[:, 0]
        days = raw[:, 8:].copy().view("<i4")[:, 0].astype(np.int64)
        return (days - JULIAN_EPOCH) * 86_400_000_000_000 + nanos
    out = np.empty(count, object)
    if ptype == "FIXED_LEN_BYTE_ARRAY":
        for i in range(count):
            out[i] = bytes(data[i * type_length:(i + 1) * type_length])
        return out
    pos, unpack = 0, struct.Struct("<I").unpack_from
    for i in range(count):
        n = unpack(data, pos)[0]
        out[i] = bytes(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


# --- values and their logical types --------------------------------------------------------------------------------

def _kind(node: _Node, where: str) -> str:
    """What a leaf's values become: "str", "bytes", "bool", "date",
    "datetime64[<unit>]", or a numpy dtype name."""
    logical, detail = node.logical
    if logical in ("STRING", "ENUM", "JSON") or node.converted in ("UTF8", "ENUM", "JSON"):
        return "str"
    if node.ptype == "INT96":
        return "datetime64[ns]"
    if logical == "TIMESTAMP":  # TimestampType: isAdjustedToUTC, then the unit (a union of MILLIS, MICROS, NANOS)
        return "datetime64[" + {1: "ms", 2: "us", 3: "ns"}[next(iter(detail[2]))] + "]"
    if node.converted in ("TIMESTAMP_MILLIS", "TIMESTAMP_MICROS"):
        return "datetime64[ms]" if node.converted == "TIMESTAMP_MILLIS" else "datetime64[us]"
    if logical == "DATE" or node.converted == "DATE":
        return "date"
    if logical == "INTEGER":
        return f"{'' if detail.get(2, True) else 'u'}int{detail.get(1, 32)}"
    if node.converted and node.converted[:4] in ("UINT", "INT_"):
        return node.converted.lower().replace("_", "")
    if logical not in (None, "UNKNOWN") or node.converted not in (None, "BSON"):
        raise ValueError(f"{where}: logical type {logical or node.converted} is not supported")
    if node.ptype in ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"):
        return "bytes"
    return {"BOOLEAN": "bool", "INT32": "int32", "INT64": "int64", "FLOAT": "float32", "DOUBLE": "float64"}[
        node.ptype]


def _convert(values, kind: str):
    if kind == "str":
        out = np.empty(len(values), object)
        out[:] = [v.decode("utf-8") for v in values]
        return out
    if kind == "date":
        return np.asarray(values, np.int64).astype("datetime64[D]")
    if kind in ("bytes", "bool"):
        return values
    return np.asarray(values).astype(kind)


def _with_nulls(values: np.ndarray, present: np.ndarray, kind: str, top: bool) -> np.ndarray:
    """``values`` (one for each ``present`` slot) spread over every slot,
    nulls filled as pandas fills them for a column of this kind: NaN in
    floats (and in integers, which a null makes float64), NaT in timestamps,
    None in objects (NaN in a top-level string column)."""
    n, missing = len(present), not present.all()
    if kind.startswith("float") or (kind.startswith(("int", "uint")) and missing):
        out = np.full(n, np.nan, "float64" if not kind.startswith("float") else kind)
    elif kind.startswith("datetime64"):
        out = np.full(n, np.datetime64("NaT"), kind)
    elif kind == "bool" and not missing:
        out = np.zeros(n, bool)
    elif kind.startswith(("int", "uint")):
        out = np.zeros(n, kind)
    else:
        out = np.full(n, np.nan if (kind == "str" and top) else None, object)
    if kind == "date":
        out[present] = [d.item() for d in values]
    else:
        out[present] = values
    return out


class _Leaf:
    """One column's levels and non-null values, across its row groups."""

    def __init__(self, node: _Node):
        self.node = node
        self.defs: list[np.ndarray] = []
        self.reps: list[np.ndarray] = []
        self.values: list = []

    def finish(self) -> None:
        n = sum(len(d) for d in self.defs)
        self.defs = np.concatenate(self.defs) if self.defs else np.zeros(0, np.int64)
        self.reps = np.concatenate(self.reps) if self.reps else np.zeros(n, np.int64)
        self.values = np.concatenate(self.values) if self.values else np.zeros(0)
        self.starts = np.flatnonzero(self.reps == 0)  # each row's first entry


def _read_chunk(raw, meta: dict, leaf: _Leaf, kind: str, where: str) -> None:
    """Decode a column chunk's pages into ``leaf``."""
    node, codec = leaf.node, CODECS[meta[4]]
    total, pos, seen, dictionary = meta[5], 0, 0, None
    while seen < total:
        reader = _Compact(raw, pos)
        header = reader.struct()
        start, size = reader.pos, header[3]
        page = raw[start:start + size]
        pos = start + size
        page_type = header[1]
        if page_type == INDEX_PAGE:
            continue
        if page_type == DICTIONARY_PAGE:
            info = header[7]
            if info.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ValueError(f"{where}: dictionary page encoding {ENCODINGS.get(info[2], info[2])} is not "
                                 "supported")
            data = _decompress(page, codec, where)
            dictionary = _convert(_plain(data, node.ptype, info[1], node.type_length), kind)
            continue
        if page_type == DATA_PAGE:
            info = header[5]
            count, encoding = info[1], info[2]
            data = memoryview(_decompress(page, codec, where))
            at = 0
            levels = []
            for max_level, enc in ((node.max_rep, info.get(4, RLE)), (node.max_def, info.get(3, RLE))):
                if max_level == 0:
                    levels.append(None)
                    continue
                if enc != RLE:
                    raise ValueError(f"{where}: level encoding {ENCODINGS.get(enc, enc)} is not supported")
                length = struct.unpack_from("<I", data, at)[0]
                levels.append(_decode_hybrid(data, at + 4, at + 4 + length, max_level.bit_length(), count))
                at += 4 + length
            reps, defs = levels
            body = data[at:]
        elif page_type == DATA_PAGE_V2:
            info = header[8]
            count, encoding = info[1], info[4]
            def_len, rep_len = info[5], info[6]
            page = memoryview(page)
            reps = _decode_hybrid(page, 0, rep_len, node.max_rep.bit_length(), count) if node.max_rep else None
            defs = (_decode_hybrid(page, rep_len, rep_len + def_len, node.max_def.bit_length(), count)
                    if node.max_def else None)
            rest = page[rep_len + def_len:]
            body = memoryview(_decompress(rest, codec, where) if info.get(7, True) else bytes(rest))
        else:
            raise ValueError(f"{where}: page type {page_type} is not a parquet page")
        defs = defs if defs is not None else np.full(count, node.max_def, np.int64)
        present = int((defs == node.max_def).sum())
        if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{where}: a dictionary-encoded page without a dictionary page")
            indices = _decode_hybrid(body, 1, len(body), body[0], present) if present else np.zeros(0, np.int64)
            values = dictionary[indices]
        elif encoding == PLAIN:
            values = _convert(_plain(body, node.ptype, present, node.type_length), kind)
        elif encoding == RLE and node.ptype == "BOOLEAN":
            length = struct.unpack_from("<I", body, 0)[0]
            values = _decode_hybrid(body, 4, 4 + length, 1, present).astype(bool)
        else:
            raise ValueError(f"{where}: encoding {ENCODINGS.get(encoding, encoding)} is not supported")
        leaf.defs.append(defs)
        leaf.reps.append(reps if reps is not None else np.zeros(count, np.int64))
        leaf.values.append(values)
        seen += count


# --- assembly ------------------------------------------------------------------------------------------------------

class _Assembler:
    """Builds each top-level field's column from its leaves' levels, with at
    most one repeated level under it (a list of values or of groups).

    A node is built at ``slots``: row numbers, or, inside a list, the level
    entries of the list's leaves (which line up across them)."""

    def __init__(self, leaves: dict, kinds: dict, path: str):
        self.leaves, self.kinds, self.path = leaves, kinds, path

    def column(self, node: _Node, num_rows: int) -> np.ndarray:
        return self.build(node, np.arange(num_rows), False, top=True)

    def first(self, node: _Node) -> _Leaf:
        return self.leaves[node.leaves()[0].path]

    def entries(self, node: _Node, slots: np.ndarray, in_list: bool) -> np.ndarray:
        """The entry of ``node``'s first leaf at each slot."""
        return slots if in_list else self.first(node).starts[slots]

    def build(self, node: _Node, slots: np.ndarray, in_list: bool, top: bool = False) -> np.ndarray:
        if node.logical[0] == "MAP" or node.converted in ("MAP", "MAP_KEY_VALUE"):
            raise ValueError(f"{self.path}: column {node.dotted}: MAP is not supported")
        if node.is_list() or node.repetition == REPEATED:
            if in_list:
                raise ValueError(f"{self.path}: column {node.dotted}: nested lists are not supported")
            return self.build_list(node, slots)
        if node.ptype is not None:
            return self.leaf_values(node, self.entries(node, slots, in_list), top)
        null = self.first(node).defs[self.entries(node, slots, in_list)] < node.max_def
        out = np.full(len(slots), None, object)
        for i, row in zip(np.flatnonzero(~null), self.group_rows(node, slots[~null], in_list)):
            out[i] = row
        return out

    def leaf_values(self, node: _Node, entries: np.ndarray, top: bool) -> np.ndarray:
        leaf = self.leaves[node.path]
        present = leaf.defs == node.max_def
        rank = np.cumsum(present) - 1  # each entry's place among the values
        keep = present[entries]
        return _with_nulls(leaf.values[rank[entries][keep]], keep, self.kinds[node.path], top)

    def group_rows(self, node: _Node, slots: np.ndarray, in_list: bool) -> list[dict]:
        """A group's fields as a dict at each slot, each field's column as
        a list (Python scalars), None where the field is null."""
        fields = {}
        for child in node.children:
            col = self.build(child, slots, in_list)
            values = col.tolist() if col.dtype != object else list(col)
            present = self.first(child).defs[self.entries(child, slots, in_list)] >= child.max_def
            fields[child.name] = [v if p else None for v, p in zip(values, present)]
        return [dict(zip(fields, values)) for values in zip(*fields.values())]

    def build_list(self, node: _Node, rows: np.ndarray) -> np.ndarray:
        if node.repetition == REPEATED:  # an unannotated repeated field: a list that is never null
            repeated, element, list_def = node, node, node.max_def - 1
        else:
            if len(node.children) != 1 or node.children[0].repetition != REPEATED:
                raise ValueError(f"{self.path}: column {node.dotted}: a LIST without one repeated field")
            repeated = node.children[0]
            # the three-level form holds the element inside the repeated group; in the legacy two-level forms
            # the repeated field is the element (a value, or a group of its fields)
            three = (repeated.ptype is None and len(repeated.children) == 1 and repeated.name != "array"
                     and repeated.name != node.name + "_tuple")
            element, list_def = (repeated.children[0] if three else repeated), node.max_def
        leaf = self.first(node)
        entries = np.flatnonzero(leaf.defs >= repeated.max_def)  # one for each element of the column
        counts = np.bincount(np.searchsorted(leaf.starts, entries, side="right") - 1, minlength=len(leaf.starts))
        bounds = np.concatenate([[0], np.cumsum(counts)])
        if element is not repeated:
            elements = self.build(element, entries, True)
        elif element.ptype is not None:
            elements = self.leaf_values(element, entries, False)
        else:
            elements = np.empty(len(entries), object)
            elements[:] = self.group_rows(element, entries, True)
        out = np.full(len(rows), None, object)
        for i in np.flatnonzero(leaf.defs[leaf.starts[rows]] >= list_def):
            out[i] = elements[bounds[rows[i]]:bounds[rows[i] + 1]]
        return out


# --- the file ------------------------------------------------------------------------------------------------------

def _footer(path) -> dict:
    """The footer's ``FileMetaData`` as ``{field id: value}``."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{path}: {size} bytes is too short for a parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        f.seek(0)
        head = f.read(4)
        if head != MAGIC or tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a parquet file (no PAR1 magic)")
        length = struct.unpack("<I", tail[:4])[0]
        f.seek(size - 8 - length)
        return _Compact(f.read(length)).struct()


def read_table(path) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """``({column name: values}, index)`` of a parquet file, each column as
    ``pandas.read_parquet`` gives it (module docstring), the index as a
    RangeIndex's values or the stored index column's (tuples for several)."""
    path = Path(path)
    meta = _footer(path)
    root = _schema(meta[2])
    pandas_meta = {}
    for kv in meta.get(5) or []:
        if kv.get(1) == b"pandas" and kv.get(2):
            pandas_meta = json.loads(kv[2])
    index_spec = pandas_meta.get("index_columns", [])
    leaves, kinds = {}, {}
    for field in root.children:
        for node in field.leaves():
            leaves[node.path] = _Leaf(node)
            kinds[node.path] = _kind(node, f"{path}: column {node.dotted}")
    with open(path, "rb") as f:
        for group in meta.get(4) or []:
            for chunk in group[1]:
                cmeta = chunk[3]
                key = tuple(p.decode("utf-8") for p in cmeta[3])
                if chunk.get(1):
                    raise ValueError(f"{path}: column {'.'.join(key)} lies in another file ({chunk[1]!r})")
                f.seek(min(o for o in (cmeta.get(11), cmeta[9]) if o))  # the dictionary page first, if any
                raw = memoryview(f.read(cmeta[7]))
                _read_chunk(raw, cmeta, leaves[key], kinds[key], f"{path}: column {'.'.join(key)}")
    for leaf in leaves.values():
        leaf.finish()
    assembler = _Assembler(leaves, kinds, str(path))
    num_rows = meta[3]
    out = {field.name: assembler.column(field, num_rows) for field in root.children}
    index_columns = []
    for spec in index_spec:
        if isinstance(spec, dict):
            if spec.get("kind") == "range":
                index_columns.append(np.arange(spec["start"], spec["stop"], spec["step"]))
        else:
            index_columns.append(out.pop(spec))
    if not index_columns:
        index = np.arange(num_rows)
    elif len(index_columns) == 1:
        index = index_columns[0]
    else:
        index = np.empty(num_rows, object)
        index[:] = list(zip(*index_columns))
    return out, index


def as_python(value):
    """A cell as pandas boxes it in ``to_dict``: Python scalars, a
    ``datetime`` for a timestamp (None for NaT)."""
    if isinstance(value, np.datetime64):
        return None if np.isnat(value) else value.astype("datetime64[us]").item()
    if isinstance(value, np.generic):
        return value.item()
    return value


def table_row(columns: dict[str, np.ndarray], i: int) -> dict:
    """Row ``i`` as ``df.iloc[i].to_dict()`` gives it."""
    return {name: as_python(col[i]) for name, col in columns.items()}
