"""The SAVi training cell on a tiny world on the CPU: the reference agrees
with the port on every compared layer, and each fault the cell can have,
planted under the timed path, turns ``correct`` false."""

import pytest


def test_reference_agrees_with_the_port(tiny_run):
    result, out = tiny_run()
    numbers = {c["name"]: c["value"] for c in out["compared"]}
    assert set(numbers) == {"spectrogram", "value", "log_prob", "belief", "loss", "first_grad", "param_change", "frozen_moved"}
    # both sides run the same float32 operations on the CPU; only the
    # order of sums differs
    assert all(v < 1e-4 for v in numbers.values()), numbers
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_env_steps_per_s", "step_ms_p95", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault,caught_by", [
    ("still_step", "param_change"),
    ("half_batch", "loss"),
    ("altered_spectrogram", "spectrogram"),
    ("altered_value", "value"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_run, fault, caught_by):
    from portbench.faults import FAULTS

    with FAULTS[fault]():
        result, out = tiny_run(seed=7)
    numbers = {c["name"]: c for c in out["compared"]}
    assert result["correct"] is False
    assert numbers[caught_by]["value"] > numbers[caught_by]["limit"], numbers


def test_traced_run_reports_the_per_layer_metrics(tiny_run):
    result, _ = tiny_run(seed=11, trace=1)
    # on the CPU there is no device trace: what reads it stays silent
    assert {"update_ms.train", "belief_step_ms.train", "env_step_host_ms.train", "act_host_ms.train",
            "mfu.train"} <= set(result["metrics"])
    assert not any(k.endswith("_roofline.train") for k in result["metrics"])
    assert result["correct"] is True
