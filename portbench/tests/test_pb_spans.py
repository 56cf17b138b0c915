"""The trace reduction given the program's span names among its labels: a
span annotation is never a device operation, and the idle gaps are named
by the innermost program span running at their start."""

import pytest

from avlen_tpu_torch.utils.profiling import SPAN_NAMES
from portbench import harness


def test_span_annotations_are_not_device_operations():
    # (name, on the device, start µs, duration µs, a user annotation); the
    # card mirrors each record_function as a device range, flagged or not
    events = [
        ("portbench.window", False, 0.0, 100.0, True),
        ("collect.step", False, 0.0, 60.0, True),
        ("collect.act", False, 5.0, 30.0, True),
        ("act.towers", False, 6.0, 20.0, True),
        ("collect.step", True, 0.0, 60.0, True),
        ("act.towers", True, 6.0, 20.0, False),
        ("env.audio", True, 40.0, 10.0, False),
        ("k1", True, 10.0, 10.0, False),
        ("k2", True, 70.0, 5.0, False),
    ]
    red = harness.reduce_trace(events, tuple(SPAN_NAMES) + ("portbench.window",), (0.0, 100.0))
    assert [name for name, _, _ in red["ops"]] == ["k1", "k2"]
    assert red["busy_s"] == pytest.approx(15e-6)
    # 0-10 opens in collect.step, 20-70 in act.towers, 75-100 in the window alone
    assert dict(red["idle_gaps"]) == {"collect.step": pytest.approx(10e-6), "act.towers": pytest.approx(50e-6),
                                      "portbench.window": pytest.approx(25e-6)}


def test_every_span_name_is_a_label_name():
    assert len(set(SPAN_NAMES)) == len(SPAN_NAMES)
    assert all(n and " " not in n and len(n) <= 64 for n in SPAN_NAMES)
