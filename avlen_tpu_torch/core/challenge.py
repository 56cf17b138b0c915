"""Benchmark + Challenge: agent evaluation, local or over the wire.

PyTorch counterpart of ``avlen_tpu/core/challenge.py``, the reference's
evaluation entry points:

- ``soundspaces/benchmark.py:26-170`` — ``Benchmark`` with ``local_evaluate``
  (episode loop over one env) and ``remote_evaluate`` (the habitat-challenge
  protocol: an agent-side client driving an evaluation server over gRPC with
  pickled payloads in a one-field ``evaluation_pb2.Package`` message).
- ``soundspaces/challenge.py:17-26`` — ``Challenge`` reading
  ``CHALLENGE_CONFIG_FILE`` and logging the submitted agent's metrics.

The RPC surface is the reference's, ``/evaluation.Environment/{num_episodes,
reset, episode_over, act_on_environment, get_metrics,
evalai_update_submission}``, served with gRPC *generic* method handlers and
a hand-rolled encoder of the one-field proto (field 1, length-delimited), so
no protoc codegen is needed; the bytes on the wire are the JAX package's
and ``evaluation_pb2.Package``'s. ``grpc`` is imported inside the calls that
need it.

The environment side hosts the batched env with ONE slot on its device:
episodes are dealt exactly once (``rl/trainers/base.exact_once_deal``), and
the env's auto-reset (done → the next episode's first observation) gives
habitat's reset/step/episode_over/get_metrics lifecycle.

Security note: payloads are pickled, exactly like the reference protocol —
only run the server on trusted/localhost transports.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, Optional, Union

import numpy as np
import torch

from avlen_tpu_torch.utils.logging import logger

_SERVICE = "/evaluation.Environment/"


# ---------------------------------------------------------------------------
# evaluation_pb2.Package codec: message { bytes SerializedEntity = 1; }
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def pack_package(payload: bytes = b"") -> bytes:
    """Serialize a Package (proto3: empty field ⇒ empty message)."""
    if not payload:
        return b""
    return b"\x0a" + _varint(len(payload)) + payload


def unpack_package(msg: bytes) -> bytes:
    """Parse a Package; returns the SerializedEntity bytes (b'' if unset)."""
    if not msg:
        return b""
    if msg[0] != 0x0A:
        raise ValueError(f"not a Package message (leading byte {msg[0]:#x})")
    n = 0
    shift = 0
    i = 1
    while True:
        b = msg[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not (b & 0x80):
            break
        shift += 7
    return msg[i : i + n]


def _pack_entity(entity) -> bytes:
    return pack_package(pickle.dumps(entity))


def _unpack_entity(msg: bytes):
    payload = unpack_package(msg)
    return pickle.loads(payload) if payload else None


# ---------------------------------------------------------------------------
# single-episode lifecycle over the batched env (habitat Env semantics)
# ---------------------------------------------------------------------------
class _SingleEnv:
    """One-slot view of BatchedAudioNavEnv with habitat's episode lifecycle:
    reset() → obs, step(action) → obs, episode_over, get_metrics() for the
    just-finished episode (habitat/core/env.py surface, used by
    benchmark.py:121-154)."""

    def __init__(self, config, num_episodes: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        from avlen_tpu_torch.rl.trainers.base import exact_once_deal
        from avlen_tpu_torch.sim.builder import construct_batched_env

        self.env = construct_batched_env(config, num_envs=1, device=device)
        total = int(self.env.eps["scene"].shape[0])
        self.num_episodes = min(num_episodes or total, total)
        order = torch.as_tensor(exact_once_deal(self.num_episodes, 1))
        self._state, self._obs = self.env.reset(order=order)
        self.episode_over = False
        self._metrics: Dict[str, float] = {}

    def reset(self):
        # auto-reset env: after a done step the state/obs already belong to
        # the next dealt episode, so reset() just hands out the current obs
        self.episode_over = False
        return self._host_obs()

    def step(self, action) -> Dict[str, np.ndarray]:
        from avlen_tpu_torch.rl.trainers.base import METRIC_BLACKLIST

        if isinstance(action, dict):  # habitat agents may return {"action": k}
            action = action.get("action", 0)
        acts = torch.full((1,), int(action), dtype=torch.long, device=self.env.device)
        self._state, out = self.env.step(self._state, acts)
        self._obs = out.obs
        if bool(out.done[0]):
            self.episode_over = True
            self._metrics = {
                k: float(v[0]) for k, v in out.metrics.items() if k not in METRIC_BLACKLIST
            }
        return self._host_obs()

    def get_metrics(self) -> Dict[str, float]:
        return dict(self._metrics)

    def _host_obs(self) -> Dict[str, np.ndarray]:
        return {k: v[0].cpu().numpy() for k, v in self._obs.items()}


# ---------------------------------------------------------------------------
# server (environment side of the challenge protocol)
# ---------------------------------------------------------------------------
class EvaluationServer:
    """Hosts an env behind the reference's remote-eval RPC surface
    (the counterpart of the habitat-challenge ``evalai_environment_habitat``
    container the reference's remote_evaluate talks to)."""

    def __init__(self, config, port: int = 8085, num_episodes: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        from concurrent import futures

        import grpc

        self._env = _SingleEnv(config, num_episodes, device=device)
        self._submitted = False

        rpcs = {
            "num_episodes": lambda _: {"num_episodes": self._env.num_episodes},
            "reset": lambda _: {"observations": self._env.reset()},
            "episode_over": lambda _: {"episode_over": self._env.episode_over},
            "act_on_environment": lambda action: {
                "observations": self._env.step(action)
            },
            "get_metrics": lambda _: {"metrics": self._env.get_metrics()},
            "evalai_update_submission": self._mark_submitted,
        }

        def handler_for(fn):
            def unary(request: bytes, context):
                return _pack_entity(fn(_unpack_entity(request)))

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )

        class Generic(grpc.GenericRpcHandler):
            def service(self, details):
                name = details.method
                if not name.startswith(_SERVICE):
                    return None
                fn = rpcs.get(name[len(_SERVICE):])
                return handler_for(fn) if fn else None

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((Generic(),))
        self.port = self._server.add_insecure_port(f"localhost:{port}")
        if self.port == 0:
            raise RuntimeError(f"could not bind localhost:{port}")

    def _mark_submitted(self, _):
        self._submitted = True
        logger.info("challenge submission recorded")
        return {"ok": True}

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = None):
        self._server.stop(grace)

    def wait(self):
        self._server.wait_for_termination()


# ---------------------------------------------------------------------------
# agent side
# ---------------------------------------------------------------------------
class Benchmark:
    """Agent evaluation, local (in-process env) or remote (challenge RPC).

    benchmark.py:26-170 parity: ``evaluate(agent, num_episodes)`` averages
    the env metrics over episodes; agents expose ``reset()`` and
    ``act(observations) -> action``."""

    def __init__(self, config_paths: Optional[str] = None, eval_remote: bool = False, config=None,
                 device: Union[str, torch.device] = "cuda"):
        self._eval_remote = eval_remote
        if eval_remote:
            self._env = None
        else:
            if config is None:
                # config_paths is a TASK config, as in the reference
                # (benchmark.py:37: get_task_config(config_paths))
                from avlen_tpu_torch.config import get_config, get_task_config

                config = get_config()
                if config_paths:
                    config.defrost()
                    config.TASK_CONFIG = get_task_config(config_paths)
                    config.freeze()
            self._env = _SingleEnv(config, device=device)

    # -- remote (benchmark.py:45-119; EVALENV_ADDPORT, default localhost:8085)
    def remote_evaluate(self, agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        import grpc

        addr = os.environ.get("EVALENV_ADDPORT", "localhost:8085")
        channel = grpc.insecure_channel(addr)

        def rpc(name, entity=None):
            call = channel.unary_unary(
                _SERVICE + name,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            return _unpack_entity(call(_pack_entity(entity)))

        base = rpc("num_episodes")["num_episodes"]
        num_episodes = min(num_episodes or base, base)
        agg: Dict[str, float] = defaultdict(float)
        count = 0
        while count < num_episodes:
            agent.reset()
            res = rpc("reset")
            while not rpc("episode_over")["episode_over"]:
                action = agent.act(res["observations"])
                res = rpc("act_on_environment", action)
            for m, v in rpc("get_metrics")["metrics"].items():
                agg[m] += v
            count += 1
        rpc("evalai_update_submission")
        channel.close()
        return {k: v / count for k, v in agg.items()}

    # -- local (benchmark.py:121-154)
    def local_evaluate(self, agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        env = self._env
        num_episodes = min(num_episodes or env.num_episodes, env.num_episodes)
        if num_episodes <= 0:
            raise ValueError("num_episodes should be greater than 0")
        agg: Dict[str, float] = defaultdict(float)
        count = 0
        while count < num_episodes:
            agent.reset()
            observations = env.reset()
            while not env.episode_over:
                observations = env.step(agent.act(observations))
            for m, v in env.get_metrics().items():
                agg[m] += v
            count += 1
        return {k: v / count for k, v in agg.items()}

    def evaluate(self, agent, num_episodes: Optional[int] = None) -> Dict[str, float]:
        if self._eval_remote:
            return self.remote_evaluate(agent, num_episodes)
        return self.local_evaluate(agent, num_episodes)


class Challenge(Benchmark):
    """challenge.py:17-26: config from CHALLENGE_CONFIG_FILE, submit logs."""

    def __init__(self, eval_remote: bool = False, device: Union[str, torch.device] = "cuda"):
        super().__init__(os.environ["CHALLENGE_CONFIG_FILE"], eval_remote=eval_remote, device=device)

    def submit(self, agent):
        metrics = self.evaluate(agent)
        for k, v in metrics.items():
            logger.info(f"{k}: {v}")
        return metrics
