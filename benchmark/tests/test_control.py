"""On the card: each cell's control (the reference in the program's place,
a precision lower than the configuration states) and each planted fault
come out not correct, at the cell's own sizes with a short window.

    python -m pytest benchmark/tests/test_control.py   # on a machine with a card
"""

import json
import os

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(
    harness.ROOT, "BENCHMARK.json")))["workloads"]]
JUDGED = {"train_xe": ("control", "drop_half")}


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(card, name):
    cell = harness.resolve(name)
    for judged in JUDGED.get(cell.traffic["driver"], ("control",)):
        line = harness.execute(cell, 3_100_000_000, 2.0, False,
                               control=judged)
        assert not line["correct"], (judged, line["checks"])
