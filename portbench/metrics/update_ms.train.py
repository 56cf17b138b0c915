"""Mean device-stream time of one PPO update (GAE, the minibatches, the belief step), from CUDA
events around each update of the traced window."""

UNIT = "ms"
LAYER = "Trainer loop (rl/trainers/savi.py superstep, rl/ppo.py)"
MOVES = "train_env_steps_per_s"


def read(rec):
    ms = rec.get("update_ms")
    return sum(ms) / len(ms) if ms else None
