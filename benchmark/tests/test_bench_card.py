"""On the card, at each cell's own size: the control (the reference in the
program's place, with TF32 on for its convolutions and matmuls) comes out
not correct, and the program comes out correct."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import run
from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, program, seed):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "3", "--trace", "0"],
                        program=program) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    assert _run(cell, "control", 3_000_000_061)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    assert _run(cell, "port", 3_000_000_067)["correct"] is True
