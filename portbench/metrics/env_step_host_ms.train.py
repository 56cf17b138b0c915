"""Host milliseconds of the batched env's step call per acting step (the enqueue of
rendering, audio and bookkeeping), on the host clock over the traced window."""

UNIT = "ms"
LAYER = "Rollout and env (rl/rollout_smt.py, sim/env.py, ops/audio.py)"
MOVES = "train_env_steps_per_s"


def read(rec):
    return rec.get("env_step_host_ms")
