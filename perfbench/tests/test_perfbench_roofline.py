"""The frozen roofline copy against the program's, at SparK b128's fused
stages."""

import pytest

from cmx_torch.utils import roofline as program
from perfbench import roofline as frozen

STAGES = frozen.fused_encoder_stages([64, 128, 256, 512], 256)


def test_fused_stages_are_down1_and_down2():
    assert STAGES == [(256, 256, 1, 64, False), (256, 256, 64, 64, True),
                      (128, 128, 64, 128, True), (128, 128, 128, 128, True)]


@pytest.mark.parametrize("stage", STAGES)
def test_work_equals_the_programs(stage):
    h, w, ci, c, dx = stage
    assert frozen.conv3x3_fwd_work(128, h, w, ci, c) == \
        program.conv3x3_fwd_work(128, h, w, ci, c)
    assert frozen.conv3x3_bwd_work(128, h, w, ci, c, dx) == \
        program.conv3x3_bwd_work(128, h, w, ci, c, dx)


def test_bounds_equal_the_programs_table():
    rows = {r["kernel"]: r for r in program.table(128, STAGES, [], [])}
    assert frozen.stages_bound_ms(128, STAGES, False) == \
        pytest.approx(rows["K1"]["bound_ms"], rel=1e-12)
    assert frozen.stages_bound_ms(128, STAGES, True) == \
        pytest.approx(rows["K2"]["bound_ms"], rel=1e-12)
    assert (frozen.PEAK_BYTES, frozen.PEAK_BF16, frozen.PEAK_FP32) == \
        (program.PEAK_BYTES, program.PEAK_BF16, program.PEAK_FP32)
