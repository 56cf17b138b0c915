"""Host milliseconds of the policy's act call per acting step (towers, SMT, heads,
sampling), on the host clock over the traced window."""

UNIT = "ms"
LAYER = "Policies (models/smt_policy.py, models/smt.py, models/belief_predictor.py)"
MOVES = "train_env_steps_per_s"


def read(rec):
    return rec.get("act_host_ms")
