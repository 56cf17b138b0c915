"""CPU tests of the benchmark at tiny sizes; tests marked ``cuda`` run on the card.

Run from the repository root: ``python -m pytest portbench/tests -q``.
Whether a card is present is decided inside the ``card`` fixture, never
while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny SAVi world: 4 envs, 6-step rounds, 4 kHz audio with 2,000-tap RIRs
# rendered every step (no spectrogram bank), 32-px frames, an 8-slot ring
TINY = ("NUM_PROCESSES", 4, "RL.PPO.num_steps", 6, "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", 4,
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", 2000, "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", 4000,
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", 32, "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", 20,
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", 8, "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", False)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """``run(seed, trace=0)``: one run of savi.train.e32 on the tiny world
    on the CPU; returns (result, driver output)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench import harness, run

    harness.prepare_environment()

    def go(seed: int = 2147483701, trace: int = 0):
        args = run.parse(["--workload", "savi.train.e32", "--seed", str(seed), "--seconds", "0", "--trace", str(trace)])
        return run.run_cell(args, device="cpu", extra_opts=TINY)

    return go
