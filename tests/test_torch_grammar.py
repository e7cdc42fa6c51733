"""The port's word-pair grammar (``dsp_tpu_torch/ops/grammar.py``) is a copy
of the JAX package's ``dsp_tpu/ops/grammar.py``: every mask and
``describe`` line equal, for each constructor and a JSON spec file."""

import json

import numpy as np
import pytest

from dsp_tpu.ops.grammar import Grammar as JGrammar

from dsp_tpu_torch.ops.grammar import Grammar

LABELS = ("zero", "one", "two", "three")
SPECS = [
    {},
    {"start": ["one", "two"], "end": "*"},
    {"pairs": [["one", "two"], ["two", "*"]], "no_repeat": True},
    {"pairs": [["*", "*"]], "forbidden": [["one", "one"], ["*", "zero"]],
     "start": "three", "end": ["zero", "one"]},
]


def _same(got: Grammar, want: JGrammar):
    assert got.labels == want.labels
    for name in ("start", "pairs", "end"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.describe() == want.describe()


@pytest.mark.parametrize("ctor", ["loop", "no_repeat"])
def test_constructors_equal_jax(ctor):
    _same(getattr(Grammar, ctor)(LABELS), getattr(JGrammar, ctor)(LABELS))


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_spec_dicts_equal_jax(spec):
    _same(Grammar.from_spec(spec, LABELS), JGrammar.from_spec(spec, LABELS))


def test_json_file_equal_jax(tmp_path):
    path = tmp_path / "grammar.json"
    path.write_text(json.dumps(SPECS[3]))
    _same(Grammar.load(str(path), LABELS), JGrammar.load(str(path), LABELS))


def test_unit_masks_equal_jax():
    unit_ids = [0, 0, 1, 2, 2, 2, 3, 1]
    for spec in SPECS:
        got = Grammar.from_spec(spec, LABELS).unit_masks(unit_ids)
        want = JGrammar.from_spec(spec, LABELS).unit_masks(unit_ids)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="outside the grammar vocabulary"):
        Grammar.loop(LABELS).unit_masks([0, 4])
    with pytest.raises(ValueError, match="unknown word 'four'"):
        Grammar.from_spec({"start": ["four"]}, LABELS)
