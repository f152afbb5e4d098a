"""The port's YAML reader (``mapperatorinator_tpu_torch/config/yaml_reader.py``)
against PyYAML's ``safe_load``, which the JAX loader reads configs and
override values with: equal values of equal types on every file under
``configs/``, on the override forms YAML 1.1 reads differently from JSON
(``1e-3`` a string, ``010`` 8, ``0x10`` 16, ``1_000`` 1000, dates), as a
hypothesis property over scalars and flow collections of them, and a
``ValueError`` naming the file and line for each construct outside the
subset.
"""

import datetime
import math
import re

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from mapperatorinator_tpu_torch.config import parse_value
from mapperatorinator_tpu_torch.config.yaml_reader import load_file, load_string
from tests.fixtures.tiny_checkpoint import REPO_ROOT

CONFIG_FILES = sorted((REPO_ROOT / "configs").rglob("*.yaml"))


def same(a, b) -> bool:
    """Equal, with equal types at every level (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return len(a) == len(b) and all(same(ka, kb) and same(va, vb)
                                        for (ka, va), (kb, vb) in zip(a.items(), b.items()))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_the_configs_are_all_there():
    assert len(CONFIG_FILES) == 40


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: str(p.relative_to(REPO_ROOT / "configs")))
def test_reader_equals_safe_load_on_every_config(path):
    with open(path, encoding="utf-8") as f:
        want = yaml.safe_load(f)
    assert same(load_file(path), want)


# the forms where YAML 1.1 and JSON part ways, and the quoting and flow forms overrides use
NAMED = {
    "1e-3": "1e-3", "1.e-3": 0.001, "1.0e-3": 0.001, "1.0e3": "1.0e3", "1.5e+3": 1500.0, "010": 8, "08": "08",
    "0x10": 16, "0b101": 5, "1_000": 1000, "1_0.5": 10.5, "1.": 1.0, "-.5": "-.5", ".5": 0.5, ".inf": math.inf,
    "-.inf": -math.inf, "1:30": 90, "true": True, "yes": True, "On": True, "NO": False, "off": False,
    "null": None, "~": None, "Null": None, "2024-01-01": datetime.date(2024, 1, 1), "2024-1-1": "2024-1-1",
    "'010'": "010", "'it''s'": "it's", '"a\\tb\\u00e9"': "a\tb\u00e9", "a b": "a b", "a#b": "a#b", "a #c": "a",
    "[1., 1.2]": [1.0, 1.2], "[]": [], "{d_model: 64}": {"d_model": 64}, '{"a":1}': {"a": 1}, "{a:1}": {"a:1": None},
    "[a, [b, {c: d}], ]": ["a", ["b", {"c": "d"}]],
    "${..model.spectrogram.hop_length}": "${..model.spectrogram.hop_length}",
}


@pytest.mark.parametrize("raw", sorted(NAMED))
def test_named_override_forms_equal_safe_load(raw):
    got = parse_value(raw)
    assert same(got, NAMED[raw]) and same(got, yaml.safe_load(raw))


def test_an_empty_override_is_none():
    assert parse_value("") is None and yaml.safe_load("") is None


ATOMS = ["1e-3", "1.e-3", "1.0e-3", "1.5e+3", "010", "08", "0x10", "0x1F", "0b101", "1_000", "1_0.5", ".inf", "-.inf",
         "+.inf", ".nan", ".NaN", "-.5", ".5", "1.", "-1.", "+1", "-0", "0", "00", "1:30", "1:30.5", "true", "True",
         "TRUE", "yes", "Yes", "on", "ON", "off", "no", "No", "false", "null", "Null", "NULL", "~", "2024-01-01",
         "2024-1-1", "2001-12-14t21:59:43.10-05:00", "abc", "a b", "a:b", "a#b", "-a", "a-b", "'q'", "'it''s'", '"d"',
         '"a\\tb\\u00e9\\x41"', "'a # b'", '"x: y"', "${a.b}", "${..x.y}", "pallas", "x/y", "1e3", "1E-3", "0_7",
         "1.2.3", "3.", "http://x", "y", "n", "''", '""', "[]", "{}"]
scalars = st.sampled_from(ATOMS)
flow_values = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]"),
        st.lists(st.tuples(scalars, inner), max_size=3).map(
            lambda kvs: "{" + ", ".join(f"{k}: {v}" for k, v in kvs) + "}")),
    max_leaves=12)


@settings(max_examples=400, deadline=None)
@given(raw=flow_values, comment=st.sampled_from(["", " ", " # a comment"]))
def test_override_values_equal_safe_load(raw, comment):
    """Any value of these forms, nested in flow collections, reads as PyYAML
    reads it (or, where PyYAML refuses it, the reader raises too)."""
    raw += comment
    try:
        want = yaml.safe_load(raw)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            parse_value(raw)
        return
    assert same(parse_value(raw), want)


OUTSIDE = [  # (document, the 1-based line the error names, what it says)
    ("a: &x 1\nb: *x\n", 1, "anchors and aliases"),
    ("a: 1\nb: *x\n", 2, "anchors and aliases"),
    ("a: !!str 1\n", 1, "tags"),
    ("a: |\n  text\n", 1, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "document marker"),
    ("? a\n: 1\n", 1, "'?' key"),
    ("base: {x: 1}\nc:\n  <<: {y: 2}\n", 3, "merge key"),
    ("a: [1,\n  2]\n", 1, "flow collection not closed"),
    ("a: 'one\n  two'\n", 1, "quoted scalar not closed"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("a: one\n  two\n", 2, "multi-line"),
]


@pytest.mark.parametrize("text,line,what", OUTSIDE, ids=[case[2] + f" line {case[1]}" for case in OUTSIDE])
def test_outside_the_subset_raises_with_file_and_line(tmp_path, text, line, what):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"{re.escape(str(path))}:{line}: .*{what}"):
        load_file(path)
    with pytest.raises(ValueError, match=f"<string>:{line}: .*{what}"):
        load_string(text)
