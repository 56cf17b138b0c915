"""The port's Benchmark/Challenge protocol (avlen_tpu_torch/core/challenge.py)
against the JAX package's (avlen_tpu/core/challenge.py): the Package codec
writes and reads the same bytes; ``local_evaluate`` gives JAX's metrics with
tests/test_challenge.py's TINY world and ForwardAgent (1e-6); the remote
protocol over gRPC on a free localhost port gives the local metrics, and a
port agent evaluates against the JAX package's server (and the JAX client
against the port's) over the same wire; ``Challenge`` reads
CHALLENGE_CONFIG_FILE."""

import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.core import challenge as jch
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.core.challenge import (
    Benchmark,
    Challenge,
    EvaluationServer,
    _pack_entity,
    _unpack_entity,
    pack_package,
    unpack_package,
)

torch.set_num_threads(1)

TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "5",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "12",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8",
    # not in test_challenge.py's list: the bank changes only the
    # spectrogram observation, not the metrics, and rendering it takes
    # most of a CPU setup; without it every step renders its audio
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
]
METRICS_TOL = 1e-6


class ForwardAgent:
    """tests/test_challenge.py's agent: always MOVE_FORWARD; episodes end at
    the step cap or upon reaching the goal region."""

    def reset(self):
        pass

    def act(self, observations):
        assert isinstance(observations, dict) and "spectrogram" in observations
        assert observations["spectrogram"].ndim == 3  # unbatched, single-env
        return 1


class TurnThenForwardAgent(ForwardAgent):
    """Deterministic per episode: right, then forward; varies the episodes'
    ends over the step cap."""

    def reset(self):
        self.t = 0

    def act(self, observations):
        super().act(observations)
        self.t += 1
        return 3 if self.t % 3 == 1 else 1


@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 300, 16383, 16384, 70000])
def test_package_codec_bytes_equal_jax(n):
    payload = bytes(np.random.RandomState(n).randint(0, 256, n, dtype=np.uint8))
    msg = pack_package(payload)
    assert msg == jch.pack_package(payload)
    assert unpack_package(msg) == payload == jch.unpack_package(msg)
    entity = {"observations": {"spectrogram": np.arange(n % 97, dtype=np.float32)}, "n": n}
    assert _pack_entity(entity) == jch._pack_entity(entity)
    back = _unpack_entity(jch._pack_entity(entity))
    assert back["n"] == n and np.array_equal(back["observations"]["spectrogram"], entity["observations"]["spectrogram"])
    assert _unpack_entity(b"") is None
    with pytest.raises(ValueError):
        unpack_package(b"\x12\x00")


@pytest.fixture(scope="module")
def local_metrics(tmp_path_factory):
    """Both packages' local_evaluate on the TINY world: ForwardAgent over
    the first 3 episodes, then TurnThenForwardAgent over the next 5 (the
    env goes on with the episodes it deals)."""
    d = str(tmp_path_factory.mktemp("challenge"))
    port = Benchmark(config=get_config(opts=TINY, model_dir=d), device="cpu")
    jax = jch.Benchmark(config=jax_get_config(opts=TINY, model_dir=d))
    return {(agent_cls.__name__, n): (port.evaluate(agent_cls(), num_episodes=n),
                                      jax.evaluate(agent_cls(), num_episodes=n))
            for agent_cls, n in ((ForwardAgent, 3), (TurnThenForwardAgent, 5))}


def _same_metrics(got, want, tol=METRICS_TOL):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_local_evaluate_matches_jax(local_metrics):
    for (agent, n), (port, jax) in local_metrics.items():
        assert {"success", "spl", "softspl", "distance_to_goal"} <= set(port)
        assert all(np.isfinite(v) for v in port.values())
        _same_metrics(port, jax)


def test_remote_evaluate_matches_local(tmp_path, monkeypatch, local_metrics):
    cfg = get_config(opts=TINY, model_dir=str(tmp_path))
    server = EvaluationServer(cfg, port=0, num_episodes=3, device="cpu").start()
    try:
        monkeypatch.setenv("EVALENV_ADDPORT", f"localhost:{server.port}")
        remote = Benchmark(eval_remote=True).evaluate(ForwardAgent())
        assert server._submitted  # evalai_update_submission RPC arrived
    finally:
        server.stop(0)
    _same_metrics(remote, local_metrics["ForwardAgent", 3][0], tol=0.0)


def test_port_client_against_jax_server_and_back(tmp_path, monkeypatch, local_metrics):
    """The wire is the JAX package's: a port client evaluates through the
    JAX server, the JAX client through the port's server."""
    server = jch.EvaluationServer(jax_get_config(opts=TINY, model_dir=str(tmp_path)), port=0,
                                  num_episodes=3).start()
    try:
        monkeypatch.setenv("EVALENV_ADDPORT", f"localhost:{server.port}")
        remote = Benchmark(eval_remote=True).evaluate(ForwardAgent())
    finally:
        server.stop(0)
    _same_metrics(remote, local_metrics["ForwardAgent", 3][1], tol=0.0)
    server = EvaluationServer(get_config(opts=TINY, model_dir=str(tmp_path)), port=0, num_episodes=3,
                              device="cpu").start()
    try:
        monkeypatch.setenv("EVALENV_ADDPORT", f"localhost:{server.port}")
        remote = jch.Benchmark(eval_remote=True).evaluate(ForwardAgent())
    finally:
        server.stop(0)
    _same_metrics(remote, local_metrics["ForwardAgent", 3][0], tol=0.0)


def test_challenge_reads_config_env_var(tmp_path, monkeypatch):
    # a TASK config, as the reference's Challenge expects (challenge.py:19
    # → benchmark.py:37 get_task_config)
    cfg_yaml = tmp_path / "challenge.yaml"
    cfg_yaml.write_text(
        "DATASET:\n  SYNTHETIC:\n    SIDE: 5\n"
        "    RIR_LENGTH: 400\n    FRAME_RES: 32\n    NUM_EPISODES: 12\n"
        "SIMULATOR:\n  AUDIO:\n    RIR_SAMPLING_RATE: 4000\n    CACHE_SPECTROGRAMS: False\n"
        "ENVIRONMENT:\n  MAX_EPISODE_STEPS: 8\n"
    )
    monkeypatch.setenv("CHALLENGE_CONFIG_FILE", str(cfg_yaml))
    challenge = Challenge(device="cpu")
    assert challenge._env.env.device == torch.device("cpu")
    assert challenge._env.num_episodes == 12  # every episode of the task config's world
    metrics = challenge.submit(ForwardAgent())
    assert "success" in metrics and all(np.isfinite(v) for v in metrics.values())
    _same_metrics(metrics, jch.Challenge().submit(ForwardAgent()))
    monkeypatch.delenv("CHALLENGE_CONFIG_FILE")
    with pytest.raises(KeyError):
        Challenge(device="cpu")
