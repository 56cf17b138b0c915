"""Mean device-stream time of the belief predictor's online step, from CUDA events around
each call in the traced window."""

UNIT = "ms"
LAYER = "Trainer loop (rl/trainers/savi.py superstep, rl/ppo.py)"
MOVES = "train_env_steps_per_s"


def read(rec):
    ms = rec.get("belief_ms")
    return sum(ms) / len(ms) if ms else None
