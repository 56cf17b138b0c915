"""The AVLEN evaluation cell on a tiny world on the CPU: the driver runs end
to end through ``run.run_cell``, ``correct`` with its end-to-end metrics
untraced and its per-layer metrics traced; and the AVLEN reference loads
nothing of the program or of JAX."""

import subprocess
import sys

import pytest

from portbench import harness

CELL = "avlen.eval.e10"
# a tiny AVLEN world: 8 kHz audio with 2,000-tap RIRs rendered every
# step, 16-px frames, a 4-slot SMT memory of width 32, a 2-layer CLIP tower
# of width 32, 6-step collects (the eval runs 10 envs)
TINY = ("TASK_CONFIG.DATASET.SYNTHETIC.SIDE", 4, "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", 20,
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", 2000, "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", 16,
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", 8000, "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", False,
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", 4, "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", 32,
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", 4, "RL.PPO.CLIP_WIDTH", 32, "RL.PPO.CLIP_LAYERS", 2,
        "RL.PPO.num_steps", 6)


@pytest.fixture
def avlen_run(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench import run

    harness.prepare_environment()

    def go(seed: int, trace: int):
        args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0", "--trace", str(trace)])
        return run.run_cell(args, device="cpu", extra_opts=TINY)

    return go


def test_untraced_run_is_correct_and_reports_its_end_to_end_metrics(avlen_run):
    result, out = avlen_run(2200000101, 0)
    assert result["correct"] is True, out["compared"]
    assert set(result["metrics"]) == {"step_ms_p95", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {c["name"] for c in out["compared"]} == set(harness.workload_file(CELL)["limits"])


def test_traced_run_reports_the_per_layer_metrics(avlen_run):
    result, out = avlen_run(2200000102, 1)
    assert result["correct"] is True, out["compared"]
    metrics = {name: m["value"] for name, m in result["metrics"].items()}
    # on the CPU there is no device trace: the SMT's roofline stays silent
    assert set(metrics) == {"option_host_ms.eval", "dialog_host_ms.eval", "clip_ms.eval", "speaker_host_ms.eval",
                            "mfu.eval"}
    assert all(harness.finite(v) and v > 0 for v in metrics.values()), metrics
    assert {m["name"] for m in harness.cell_metrics(CELL, "per_layer")} == set(metrics) | {"smt_roofline.eval"}


def test_the_avlen_reference_loads_neither_the_port_nor_jax():
    code = ("import sys; import portbench.reference.avlen, portbench.reference.clip, portbench.reference.speaker; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'avlen_tpu_torch', 'avlen_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out
