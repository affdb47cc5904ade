"""The control on the card: the reference in TF32 in the program's place
comes out not correct at the cell's own size, and the reference against
itself in f32 reads 0 on every number.  Run on the card with
``python3 -m pytest bench_h100/tests/test_bench_control.py``."""

import pytest

from bench_h100.harness import control

CELLS = ["toucan_hifigan.interactive", "toucan_bigvgan.read_aloud", "toucan_hifigan.override"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    assert control.control(cell, 3_000_000_031)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_reference_against_itself_reads_zero(cell):
    out = control.control(cell, 3_000_000_032, precision="float32", count=16)
    assert out["correct"] is True and not any(out["numbers"].values())
