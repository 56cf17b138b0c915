"""The spectrogram kernel's share of its roofline over the profiled round."""

UNIT = "%"
LAYER = "Audio kernels (ops/irfft_cuda.py, ops/spectrogram_cuda.py)"
MOVES = "train_env_steps_per_s"


def read(rec):
    from portbench import harness

    return harness.roofline_share(rec, "spectrogram")
