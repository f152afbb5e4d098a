"""The port's ``utils/embedding_svm`` and ``utils/find_unique_beatmaps``
against the repo's JAX-stack scripts, on a tiny DiT bundle both read (48
classes, every tensor from N(0, 0.02)):

* ``embedding_svm``: the same train accuracy and every row's probability
  on both of the probe's branches, the calibrated linear SVM (``sklearn``)
  and the least-squares fit that runs without it, as on the GPU machine;
  the titles of the top rows from a parquet table;
* ``find_unique_beatmaps``: the same rows at the same mean distances,
  farthest and nearest, from a parquet table (pandas writes it, the port's
  reader reads it) and from a csv.

The port's tools read the tables without pandas: they run with pandas and
sklearn unimportable.
"""

import sys

import numpy as np
import pandas as pd
import pytest

from mapperatorinator_tpu_torch.utils import embedding_svm, find_unique_beatmaps
from tests.test_torch_dit_tools import bundle, jax_script  # noqa: F401  (the DiT bundle fixture)

CREATORS = ["Sotarks", "Sotarks", "Other", "Sotarks", "Mapper"] * 8  # 40 rows, the classes the tools read


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A ``create_beatmap_dataframe``-like table as parquet and as csv."""
    root = tmp_path_factory.mktemp("tables")
    df = pd.DataFrame({"Title": [f"Song {i}" for i in range(len(CREATORS))], "Creator": CREATORS,
                       "BeatmapName": [f"Diff {i % 3}" for i in range(len(CREATORS))],
                       "BeatmapID": np.arange(1000, 1000 + len(CREATORS))})
    df.to_parquet(root / "beatmaps.parquet")
    df.to_csv(root / "beatmaps.csv", index=False)
    return root


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels.csv"
    rows = [(i, int(i % 3 == 0)) for i in range(0, 30, 2)]
    path.write_text("idx,label\n# a comment line\n" + "".join(f"{i},{lab}\n" for i, lab in rows))
    return path


@pytest.fixture
def no_sklearn(monkeypatch):
    for name in ("sklearn", "sklearn.calibration", "sklearn.svm"):
        monkeypatch.setitem(sys.modules, name, None)


def jax_tools():
    jax_script("utils/plot_embeddings.py")  # the JAX scripts import it by name from utils/
    return jax_script("utils/embedding_svm.py"), jax_script("utils/find_unique_beatmaps.py")


@pytest.mark.parametrize("branch", ["sklearn", "least-squares"])
def test_embedding_svm_matches_jax(bundle, labels, tables, branch, request, capsys):  # noqa: F811
    if branch == "least-squares":
        request.getfixturevalue("no_sklearn")
    jax_svm, _ = jax_tools()
    argv = ["--ckpt", str(bundle), "--labels", str(labels), "--num-classes", "40", "--top", "5",
            "--metadata", str(tables / "beatmaps.parquet")]
    np.random.seed(5)  # liblinear draws its seed from numpy's global generator
    want = jax_svm.run(jax_svm.parse_args(argv))
    want_out = capsys.readouterr().out
    np.random.seed(5)
    got = embedding_svm.run(embedding_svm.parse_args(argv))
    assert capsys.readouterr().out == want_out and "Song " in want_out
    assert got["accuracy"] == want["accuracy"] and got["probs"].shape == (40,)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("table", ["beatmaps.parquet", "beatmaps.csv"])
@pytest.mark.parametrize("nearest", [False, True], ids=["farthest", "nearest"])
def test_find_unique_beatmaps_matches_jax(bundle, tables, table, nearest, capsys):  # noqa: F811
    _, jax_unique = jax_tools()
    argv = ["--ckpt", str(bundle), "--metadata", str(tables / table), "--creator", "Sotarks", "-k", "6",
            "--num-classes", "40", *(["--nearest"] if nearest else [])]
    want = jax_unique.run(jax_unique.parse_args(argv))
    want_out = capsys.readouterr().out
    got = find_unique_beatmaps.run(find_unique_beatmaps.parse_args(argv))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) == 6
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-6)
    assert capsys.readouterr().out == want_out and "Found 24 beatmaps by Sotarks." in want_out


def test_the_tools_need_neither_pandas_nor_sklearn(bundle, labels, tables, no_sklearn, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "pandas", None)
    probe = embedding_svm.run(embedding_svm.parse_args([
        "--ckpt", str(bundle), "--labels", str(labels), "--num-classes", "40",
        "--metadata", str(tables / "beatmaps.parquet")]))
    assert np.isfinite(probe["probs"]).all()
    ranked = find_unique_beatmaps.run(find_unique_beatmaps.parse_args([
        "--ckpt", str(bundle), "--metadata", str(tables / "beatmaps.parquet"), "--creator", "Mapper"]))
    assert len(ranked) == 10
    with pytest.raises(ValueError, match="no beatmaps by 'Nobody'"):
        find_unique_beatmaps.run(find_unique_beatmaps.parse_args([
            "--ckpt", str(bundle), "--metadata", str(tables / "beatmaps.csv"), "--creator", "Nobody"]))
