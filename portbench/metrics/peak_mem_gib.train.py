"""torch.cuda.max_memory_allocated over the window, reset at its start, in GiB."""

UNIT = "GiB"
LAYER = "Device"
MOVES = "train_env_steps_per_s"


def read(rec):
    b = rec.get("peak_mem_bytes")
    return b / 2**30 if b else None
