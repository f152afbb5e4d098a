"""The port's parquet reader (``train/data/parquet.py``) against pandas.

pandas and pyarrow write tables here that the reader, which needs neither,
reads back: every column must equal ``pandas.read_parquet``'s (dtype and
values; NaN and NaT equal to themselves), and so must the index. The tables
cover every physical type with a null in each, timestamps in ms, µs and ns
(and a UTC-adjusted one, which pandas holds tz-aware and the reader as
naive UTC), INT96, dates, strings, binary, fixed-width binary, lists of
doubles, integers, strings and groups (null and empty lists, null
elements) and a group; each written SNAPPY, GZIP and uncompressed, with the
dictionary on and off, in data pages v1 and v2, across several row groups
and several pages per column chunk. A ZSTD file and a DELTA_BINARY_PACKED
column raise, naming themselves; a legacy two-level list, which pyarrow does
not write, comes from ``chip_smoke.py``'s plain writer, which pyarrow reads
equal too. The committed fixtures under ``tests/fixtures/parquet/`` (what
``chip_smoke.py`` reads on the card) hold the rows pandas reads from them.
"""

import datetime as dt
import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import chip_smoke
from mapperatorinator_tpu_torch.train.data.parquet import read_table, snappy_decompress, table_row
from tests.fixtures import parquet_fixtures

N = 53  # rows: several row groups of ROW_GROUP and several pages at PAGE_BYTES
ROW_GROUP, PAGE_BYTES = 20, 64


def every_type(n: int = N, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    null[1] = True

    def col(values, typ):
        return pa.array([None if z else v for v, z in zip(values, null)], typ)

    ints = rng.integers(-1000, 1000, n)
    stamps = [dt.datetime(2007, 1, 1) + dt.timedelta(seconds=int(s), microseconds=int(u))
              for s, u in zip(rng.integers(0, 5e8, n), rng.integers(0, 1e6, n))]
    lists = [None if z else [None if rng.random() < 0.2 else float(x) for x in rng.random(int(k))]
             for z, k in zip(null, rng.integers(0, 5, n))]
    lists[2] = []
    return pa.table({
        "int64": col(ints, pa.int64()),
        "int64_full": pa.array(ints, pa.int64()),
        "int32_full": pa.array(ints, pa.int32()),
        "int8": col(ints % 100, pa.int8()),
        "uint16_full": pa.array(np.abs(ints), pa.uint16()),
        "float32": col(rng.random(n), pa.float32()),
        "double": col(rng.random(n), pa.float64()),
        "bool": col(rng.random(n) < 0.5, pa.bool_()),
        "bool_full": pa.array(rng.random(n) < 0.5, pa.bool_()),
        "string": col([f"s{i % 7}" for i in range(n)], pa.string()),
        "string_full": pa.array([f"value {i}" for i in range(n)], pa.string()),
        "binary": col([bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in rng.integers(0, 9, n)],
                      pa.binary()),
        "fixed": col([bytes([i % 256] * 4) for i in range(n)], pa.binary(4)),
        "ts_ms": col(stamps, pa.timestamp("ms")),
        "ts_us": col(stamps, pa.timestamp("us")),
        "ts_ns": col(stamps, pa.timestamp("ns")),
        "ts_utc": col(stamps, pa.timestamp("us", tz="UTC")),
        "date": col([s.date() for s in stamps], pa.date32()),
        "list_double": pa.array(lists, pa.list_(pa.float64())),
        "list_int": pa.array([None if v is None else [None if x is None else int(x * 100) for x in v]
                              for v in lists], pa.list_(pa.int64())),
        "list_string": pa.array([None if v is None else [None if x is None else f"e{x:.2f}" for x in v]
                                 for v in lists], pa.list_(pa.string())),
        "list_group": pa.array([None if v is None else [{"x": x, "n": i} for i, x in enumerate(v)] for v in lists],
                               pa.list_(pa.struct([("x", pa.float64()), ("n", pa.int64())]))),
        "group": pa.array([None if z else {"a": None if i % 3 == 0 else int(i), "b": float(i) / 2, "c": f"c{i}",
                                           "t": stamps[i], "l": [i, i + 1]}
                           for i, z in enumerate(null)],
                          pa.struct([("a", pa.int64()), ("b", pa.float64()), ("c", pa.string()),
                                     ("t", pa.timestamp("us")), ("l", pa.list_(pa.int64()))])),
    })


def same(got, want) -> bool:
    """Equal as pandas compares cells: NaN and NaT equal to themselves,
    arrays by dtype and values, dicts by key."""
    if isinstance(want, np.ndarray):
        if not isinstance(got, np.ndarray) or got.dtype != want.dtype or got.shape != want.shape:
            return False
        if want.dtype == object:
            return all(same(g, w) for g, w in zip(got, want))
        if want.dtype.kind == "M":  # NaT is the same int64 in both
            return bool(np.array_equal(got.view("i8"), want.view("i8")))
        return bool(np.array_equal(got, want, equal_nan=want.dtype.kind in "fc"))
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(same(got[k], want[k]) for k in want)
    if isinstance(want, float) and np.isnan(want):
        return isinstance(got, float) and np.isnan(got)
    return type(got) is type(want) and got == want


def assert_reads_as_pandas(path):
    columns, index = read_table(path)
    frame = pd.read_parquet(path)
    assert list(columns) == list(frame.columns)
    for name in frame.columns:
        series = frame[name]
        if isinstance(series.dtype, pd.DatetimeTZDtype):  # the reader's timestamps are naive UTC
            series = series.dt.tz_convert(None)
        assert same(columns[name], series.to_numpy()), name
    assert same(np.asarray(index), frame.index.to_numpy()), "index"
    return columns, frame


CASES = [(codec, dictionary, version) for codec in ("snappy", "gzip", "none") for dictionary in (True, False)
         for version in ("1.0", "2.0")]


@pytest.mark.parametrize("codec,dictionary,version", CASES)
def test_every_type_reads_as_pandas(tmp_path, codec, dictionary, version):
    path = tmp_path / "t.parquet"
    pq.write_table(every_type(), path, compression=codec, use_dictionary=dictionary, data_page_version=version,
                   row_group_size=ROW_GROUP, data_page_size=PAGE_BYTES, write_batch_size=8)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 3
    pages = {meta.row_group(0).column(i).path_in_schema: meta.row_group(0).column(i).encodings
             for i in range(meta.num_columns)}
    assert ("RLE_DICTIONARY" in pages["string"]) == dictionary
    assert_reads_as_pandas(path)


def test_int96_timestamps(tmp_path):
    path = tmp_path / "t.parquet"
    table = every_type().select(["ts_ms", "ts_us", "ts_ns", "ts_utc", "group", "int64"])
    pq.write_table(table, path, use_deprecated_int96_timestamps=True, row_group_size=ROW_GROUP)
    assert pq.ParquetFile(path).schema.column(0).physical_type == "INT96"
    assert_reads_as_pandas(path)


@pytest.mark.parametrize("index", ["range", "stored", "named"])
def test_the_pandas_index(tmp_path, index):
    frame = pd.DataFrame({"a": np.arange(6) * 2.5, "s": list("abcdef")})
    if index == "range":
        frame.index = pd.RangeIndex(10, 22, 2)
    elif index == "stored":
        frame.index = [5, 3, 9, 1, 0, 7]
    else:
        frame.index = pd.Index([50, 30, 90, 10, 0, 70], name="BeatmapIdx")
    path = tmp_path / "t.parquet"
    frame.to_parquet(path)
    columns, read = assert_reads_as_pandas(path)
    assert list(columns) == ["a", "s"]
    assert np.array_equal(read_table(path)[1], frame.index.to_numpy())


def test_rows_as_pandas_gives_them(tmp_path):
    path = tmp_path / "t.parquet"
    pq.write_table(every_type(12), path)
    columns, _ = read_table(path)
    frame = pd.read_parquet(path)
    for i in range(12):
        want = frame.iloc[i].to_dict()
        got = table_row(columns, i)
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, pd.Timestamp):
                value = value.tz_convert(None).to_pydatetime() if value.tzinfo else value.to_pydatetime()
            elif value is pd.NaT:
                value = None
            assert same(got[key], value), (i, key, got[key], value)


@pytest.mark.parametrize("codec", ["zstd", "lz4", "brotli"])
def test_an_unsupported_codec_names_itself(tmp_path, codec):
    path = tmp_path / f"{codec}.parquet"
    pq.write_table(pa.table({"a": [1, 2, 3]}), path, compression=codec)
    name = {"zstd": "ZSTD", "lz4": "LZ4_RAW", "brotli": "BROTLI"}[codec]
    with pytest.raises(ValueError, match=f"codec {name} .*standard library") as err:
        read_table(path)
    assert str(path) in str(err.value) and "column a" in str(err.value)


def test_an_unsupported_encoding_names_itself(tmp_path):
    path = tmp_path / "delta.parquet"
    pq.write_table(pa.table({"a": pa.array(np.arange(100), pa.int64())}), path, use_dictionary=False,
                   column_encoding={"a": "DELTA_BINARY_PACKED"})
    with pytest.raises(ValueError, match="encoding DELTA_BINARY_PACKED") as err:
        read_table(path)
    assert str(path) in str(err.value) and "column a" in str(err.value)


def test_not_parquet(tmp_path):
    path = tmp_path / "x.parquet"
    path.write_bytes(b"PAR1" + b"\0" * 20 + b"JUNK")
    with pytest.raises(ValueError, match="not a parquet file"):
        read_table(path)


def test_snappy_overlapping_copies():
    """A literal, a copy longer than its offset (the pattern repeats) and a
    copy from one byte back, as a snappy compressor writes them."""
    stream = bytes([15,                           # 15 bytes decoded
                    (2 - 1) << 2, ord("a"), ord("b"),  # literal "ab"
                    ((10 - 4) << 2) | 1, 2,        # copy 10 from 2 back
                    ((3 - 1) << 2) | 2, 1, 0])     # copy 3 from 1 back (2-byte offset)
    assert snappy_decompress(stream) == b"ab" + b"ababababab" + b"bbb"
    with pytest.raises(ValueError, match="offset"):
        snappy_decompress(bytes([4, ((4 - 4) << 2) | 1, 1]))


def test_chip_smoke_writer_is_read_by_pyarrow_and_the_reader(tmp_path):
    """The plain writer (UNCOMPRESSED, PLAIN) that ``chip_smoke.py`` uses for
    the web shard: pyarrow reads what it writes as the reader does, the
    legacy two-level list included."""
    rows = [{"json": json.dumps({"beatmaps": [{"beatmap_id": i}]}), "opus": {"bytes": bytes([i]) * (i * 7)}}
            for i in range(5)]
    rows[3]["json"] = None
    rows[4]["opus"] = None
    path = tmp_path / "web.parquet"
    chip_smoke.write_web_shard(path, rows)
    assert pq.read_table(path).to_pylist() == rows
    assert_reads_as_pandas(path)
    columns, _ = read_table(path)
    assert [table_row(columns, i)["opus"] for i in range(5)] == [r["opus"] for r in rows]

    # optional group l (LIST) { repeated int32 element; }: the element is the repeated field itself
    legacy = tmp_path / "legacy.parquet"
    lists = [[1, 2, 3], [], [7], None, [4, 5]]
    schema = [{"name": "l", "repetition": "OPTIONAL", "converted_type": "LIST", "num_children": 1},
              {"name": "element", "repetition": "REPEATED", "type": "INT32"}]
    values = [x for v in lists if v for x in v]
    defs = [d for v in lists for d in ([0] if v is None else [1] if not v else [2] * len(v))]
    reps = [r for v in lists for r in ([0] if not v else [0] + [1] * (len(v) - 1))]
    chip_smoke.write_parquet(legacy, schema, [(values, defs, reps)], len(lists))
    assert pq.read_table(legacy).column("l").to_pylist() == lists
    columns, _ = read_table(legacy)
    assert [None if c is None else c.tolist() for c in columns["l"]] == lists and columns["l"][0].dtype == np.int32
    assert_reads_as_pandas(legacy)


@pytest.mark.parametrize("name", sorted(parquet_fixtures.FIXTURES))
def test_committed_fixtures(name):
    """Each committed fixture reads as pandas reads it, and its recorded
    rows are pandas' rows, as ``chip_smoke.py`` compares them on the card."""
    path = parquet_fixtures.FIXTURE_DIR / name
    assert_reads_as_pandas(path)
    recorded = json.loads(path.with_suffix(".json").read_text())
    frame = pd.read_parquet(path)
    assert recorded == parquet_fixtures.encode_rows([row.to_dict() for _, row in frame.iterrows()],
                                                    list(frame.index))
    columns, index = read_table(path)
    assert chip_smoke.encode_rows([table_row(columns, i) for i in range(len(index))], list(index)) == recorded
    assert sum(p.stat().st_size for p in parquet_fixtures.FIXTURE_DIR.iterdir()) < 1_000_000
