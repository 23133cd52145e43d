"""The port's YAML reader (geotrax_tpu_torch/io/yaml_load.py) against
``yaml.safe_load``: equal documents (compared by ``repr``, so types, key
order, NaN and the sign of zero count) on the four presets the port ships,
on the JAX package's four, on the YAML 1.1 resolver's edge cases one by
one, and on a seeded fuzz of 300 documents built from block mappings,
block sequences (also at their key's indentation and nested in one
line), flow sequences across lines, comments and quoted and plain scalars.
What lies outside the subset raises ``YAMLSubsetError``: anchors, aliases,
tags, block scalars, flow mappings, complex keys, merge keys, timestamps,
directives, a second document, tabs in indentation, continued scalars."""

from pathlib import Path

import numpy as np
import pytest
import yaml

from geotrax_tpu_torch.io.yaml_load import YAMLSubsetError, safe_load

ROOT = Path(__file__).resolve().parent.parent
PRESETS = ("default", "confident", "lenient", "stable")

SCALARS = [
    "1e-3", "1.0e+3", "1.5e3", "1.e-2", "yes", "No", "on", "OFF", "Off", "y", "n", "~", "null",
    "Null", "NULL", "010", "0o17", "0x1F", "-0x1f", "0b101", "1:30", "-1:30", "190:20:30.15",
    ".inf", "-.Inf", "+.INF", ".NaN", ".nan", "3.", ".5", "-.5", "1_000", "1_0.5", "+12", "-0",
    "09", "0", "00", "abc", "epsg:4326", "a b c", "b#c", "km/h", "-x", ":x", "x:y", "x?y",
    "'quoted'", "'it''s'", "''", '""', '"dq\\tx"', '"\\u00e9\\x41"', '"a\\"b"', "'#76b041'",
    "True", "FALSE", "false", "-7", "0.00000001", "123456789012345678901", "1.5", "-2.5e-3",
    "hf://org/repo/file.pt", "results", "_vid_transf", "'  spaced  '", '"#"', "'a: b'",
]
KEYS = ["a", "b_c", "0", "-1", "12", "1.5", "true", "no", "null", "~", "'q k'", '"dq"', "x y",
        "tau_c", "key"]


def same(text):
    """Equal documents, or both refuse the text (PyYAML's error, or a
    construct outside the subset)."""
    try:
        expected = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(YAMLSubsetError):
            safe_load(text)
        return
    assert repr(safe_load(text)) == repr(expected), text


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("package", ["geotrax_tpu_torch", "geotrax_tpu"])
def test_presets_read_as_pyyaml_reads_them(package, name):
    text = (ROOT / package / "cfg" / f"{name}.yaml").read_text()
    same(text)
    assert isinstance(safe_load(text)["tracker"]["botsort"], dict)


def test_the_port_ships_the_reference_presets():
    for name in PRESETS:
        assert (ROOT / "geotrax_tpu_torch" / "cfg" / f"{name}.yaml").read_text() == (
            ROOT / "geotrax_tpu" / "cfg" / f"{name}.yaml").read_text()


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalar_resolves_as_pyyaml(scalar):
    same(f"v: {scalar}\n")
    same(f"- {scalar}\n- [{scalar}, {scalar}]\n")


@pytest.mark.parametrize("key", KEYS)
def test_key_resolves_as_pyyaml(key):
    same(f"{key}: 1\nother: 2\n")


@pytest.mark.parametrize("text", [
    "", "# only a comment\n", "---\na: 1\n", "a:\n- 1\n- 2\nb: 3\n", "- a\n- b: 1\n  c: 2\n- - x\n  - y\n",
    "a:\n  b:\n    c: [1,\n      2, 'x',\n      [3]]\n  d:\n", "a: [ ]\nb: []\n", "a: [1, 2, ]\n",
    "-\n- 1\n", "a: x   # comment\n", "a:    \n", "x\n", "[1, 2]\n", "a: 'x' # c\n",
    "a:\r\n  b: 1\r\n", "a: 1\na: 2\n", "a: b c\n", "a: text with 'quotes' inside\n",
    "a: ?x\n",
])
def test_structures_read_as_pyyaml(text):
    same(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "a: >\n  text\n", "a: {b: 1}\n",
    "? a\n: 1\n", "<<: {}\n", "a: <<\n", "a: 2001-12-14\n", "a: 2001-12-14 21:59:43.10 -5\n",
    "a: =\n", "%YAML 1.1\n---\na: 1\n", "a: 1\n---\nb: 2\n", "a:\n\tb: 1\n", "a: b\n  c\n",
    "a: 'open\n  quote'\n", 'a: "x\\\n  y"\n', "a: [b, c\n", "a: [b: 1]\n", "a: [b c\n  d]\n",
    "a: b: c\n", "a: \"\\q\"\n", "- a\n b\n", "a: [?x]\n",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(YAMLSubsetError):
        safe_load(text)


def _document(rng, indent=0, depth=0) -> list:
    """Lines of a random block mapping at ``indent``."""
    pad = " " * indent
    lines = []
    for _ in range(rng.integers(1, 5)):
        if rng.random() < 0.15:
            lines.append(pad + "# a comment: [not] 'data'")
        key = KEYS[rng.integers(len(KEYS))]
        kind = rng.integers(0, 6) if depth < 3 else 0
        tail = "  # trailing" if rng.random() < 0.2 else ""
        if kind == 0:
            lines.append(f"{pad}{key}: {SCALARS[rng.integers(len(SCALARS))]}{tail}")
        elif kind == 1:
            lines.append(f"{pad}{key}:{tail}")
            lines += _document(rng, indent + 2, depth + 1)
        elif kind in (2, 3):
            lines.append(f"{pad}{key}:")
            inner = indent if kind == 2 else indent + 2
            for _ in range(rng.integers(1, 4)):
                if rng.random() < 0.3 and depth < 2:
                    sub = _document(rng, inner + 2, depth + 1)
                    lines.append(" " * inner + "- " + sub[0].lstrip(" "))
                    lines += [s for s in sub[1:]]
                else:
                    lines.append(" " * inner + "- " + SCALARS[rng.integers(len(SCALARS))])
        elif kind == 4:
            items = [SCALARS[rng.integers(len(SCALARS))] for _ in range(rng.integers(0, 5))]
            if rng.random() < 0.3 and items:
                items[0] = "[" + ", ".join(items[:2]) + "]"
            if len(items) > 2 and rng.random() < 0.5:
                lines.append(f"{pad}{key}: [{', '.join(items[:2])},")
                lines.append(f"{pad}    {', '.join(items[2:])}]{tail}")
            else:
                lines.append(f"{pad}{key}: [{', '.join(items)}]{tail}")
        else:
            lines.append("")
            lines.append(f"{pad}{key}: {SCALARS[rng.integers(len(SCALARS))]}")
    return lines


def test_seeded_fuzz_reads_as_pyyaml():
    rng = np.random.default_rng(20261017)
    for _ in range(300):
        same("\n".join(_document(rng)) + "\n")
