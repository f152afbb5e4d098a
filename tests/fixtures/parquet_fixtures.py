"""The committed parquet fixtures of ``tests/fixtures/parquet/``, written by
pandas (``to_parquet``'s defaults: pyarrow, SNAPPY, dictionary pages), each
beside the rows pandas reads from it as JSON (``chip_smoke.encode_rows``).
``chip_smoke.py`` reads them on the card with the port's reader, which must
give the same rows, and trains from ``mmrs_metadata.parquet`` with the
folders and files its rows name (``chip_smoke.write_mmrs``).

    python -m tests.fixtures.parquet_fixtures    # rewrite them

* ``mmrs_metadata.parquet``: an MMRS ``metadata.parquet`` of
  ``chip_smoke.ORS_TRACKS`` sets × ``ORS_MAPS`` maps, its rows in a
  shuffled order under a stored index (the ``BeatmapIdx`` the dataset
  takes), star ratings as a list per speed, dates as µs timestamps, and
  nulls in a column training does not read.
* ``web_shard.parquet``: a web-dataset shard of two sets, each a ``json``
  string with two maps and a second of WAV audio in ``opus.bytes``.
"""

from __future__ import annotations

import datetime
import io
import json
import wave
from pathlib import Path

import numpy as np

import chip_smoke

FIXTURE_DIR = Path(__file__).resolve().parent / "parquet"
FIXTURES = ("mmrs_metadata.parquet", "web_shard.parquet")


def wav_bytes(seconds: float, freq: float, sr: int = 16000) -> bytes:
    t = np.arange(int(sr * seconds)) / sr
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def mmrs_frame():
    import pandas as pd

    rows = []
    for set_i in range(chip_smoke.ORS_TRACKS):
        for bm_i in range(chip_smoke.ORS_MAPS):
            stars = 5.0 + 0.1 * bm_i
            rows.append({
                "Id": set_i * 10 + bm_i, "BeatmapSetId": 1000 + set_i, "ModeInt": 0, "Ranked": 1 + set_i % 2,
                "RankedDate": datetime.datetime(2020, 5, 1) + datetime.timedelta(days=set_i),
                "SubmittedDate": datetime.datetime(2019, 5, 1, 10, 30) + datetime.timedelta(days=set_i),
                "DifficultyRating": stars, "StarRating": [stars * r for r in (0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8)],
                "BeatmapSetFolder": chip_smoke.MMRS_FOLDER.format(set_i), "BeatmapFile": f"map{bm_i}.osu",
                "AudioFile": "audio.wav", "UserId": 42 + set_i, "Tags": None if bm_i % 2 else f"tag{set_i}",
            })
    order = np.random.default_rng(0).permutation(len(rows))
    return pd.DataFrame([rows[i] for i in order], index=[int(i) for i in order])


def web_frame():
    import pandas as pd

    rng = np.random.default_rng(1)
    rows = []
    for set_i in range(2):
        beatmaps = [chip_smoke.web_beatmap(set_i, bm_i, chip_smoke.OSU_TEMPLATE.format(
            i=bm_i, bid=set_i * 10 + bm_i, objects=chip_smoke.osu_objects(rng, 2.0))) for bm_i in range(2)]
        rows.append({"__key__": f"set{set_i}", "json": json.dumps({"beatmaps": beatmaps}),
                     "opus": {"bytes": wav_bytes(1.0, 220.0 + 30 * set_i)}})
    return pd.DataFrame(rows)


def encode_rows(rows: list[dict], index: list) -> dict:
    """pandas' rows as ``chip_smoke.encode_rows`` writes the reader's: a
    timestamp as its ``datetime``, NaT as None."""
    import pandas as pd

    def native(value):
        if value is pd.NaT:
            return None
        return value.to_pydatetime() if isinstance(value, pd.Timestamp) else value

    return chip_smoke.encode_rows([{k: native(v) for k, v in row.items()} for row in rows], index)


def write() -> None:
    import pandas as pd

    FIXTURE_DIR.mkdir(exist_ok=True)
    for name, frame in zip(FIXTURES, (mmrs_frame(), web_frame())):
        path = FIXTURE_DIR / name
        frame.to_parquet(path)
        read = pd.read_parquet(path)
        recorded = encode_rows([row.to_dict() for _, row in read.iterrows()], list(read.index))
        path.with_suffix(".json").write_text(json.dumps(recorded, indent=1) + "\n")


if __name__ == "__main__":
    write()
