"""On the card: the control (the program with TF32 on, the nearest
precision below the float32 the configuration states) is not correct at
the cell's own size, and the program as configured is."""

import pytest

from portbench import compare, control, harness


@pytest.mark.cuda
def test_the_tf32_control_fails_and_the_program_passes(card):
    harness.prepare_environment()
    limits = harness.workload_file("savi.train.e32")["limits"]
    program, _ = control.readings("savi.train.e32", 424242, "program", device=card)
    tf32, _ = control.readings("savi.train.e32", 424242, "tf32", device=card)
    assert compare.correct(compare.with_limits(program, limits)), program
    assert not compare.correct(compare.with_limits(tf32, limits)), tf32
