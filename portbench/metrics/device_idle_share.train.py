"""1 - the union of device operation intervals over the profiled round's wall time."""

UNIT = "fraction"
LAYER = "Device"
MOVES = "train_env_steps_per_s"


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
