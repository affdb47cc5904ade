"""The two cells that were there before families and clients were found by
name read as they did: at tiny widths on the CPU, on two seeds, the
schedule, the weights, each record's shapes and frames, the check's
numbers, the audio delivered and the model FLOPs equal what the harness
gave before the move (``golden.json``, written by ``golden.py`` from that
harness)."""

import json
from pathlib import Path

import pytest

import golden

GOLDEN = json.loads((Path(__file__).parent / "golden.json").read_text())


@pytest.mark.parametrize("cell,seed", golden.CASES)
def test_the_cell_reads_as_before(cell, seed):
    want = GOLDEN[f"{cell} {seed}"]
    got = json.loads(json.dumps(golden.observe(cell, seed)))
    assert got == want
