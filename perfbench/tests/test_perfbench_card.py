"""On the card: a cell's run is correct, and at the cell's own size the
control (the reference in float8 in the program's place) and the planted
half-batch fault fail its limits. `python -m pytest perfbench/tests -m card`
on a machine with an H100; they skip without one."""

import pytest

from perfbench import check, harness
from perfbench.cells import load_cell

CELL = "spark-b128-fused"  # the smallest cell, K1-K3 on its path
SEED = 2 ** 31 + 99


@pytest.mark.card
def test_a_run_on_the_card_is_correct(card):
    harness.set_cache_dirs()
    line = harness.run(CELL, SEED, 2.0, False)
    assert line is not None and line["correct"], line
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_and_fault_fail_at_the_cells_size(card):
    harness.set_cache_dirs()
    cell = load_cell(CELL)
    prog = harness.Program(cell, SEED, card)
    batches = [prog.batch_of(i) for i in range(harness.WARM_STEPS)]
    init = prog.init
    prog.free()
    limits = cell["workload"]["limits"]
    ref = check.follow(cell["config"], init, batches, SEED, card)
    for kw in ({"precision": "fp8"}, {"half_batch": True}):
        other = check.follow(cell["config"], init, batches, SEED, card, **kw)
        assert not check.judge(check.compare(other, ref), limits), kw
