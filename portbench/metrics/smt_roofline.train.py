"""The SMT encode kernel's share of its roofline over the profiled round: the least time
for its launches (operations counted once, against TF32 dense) over its kernels'
device time."""

UNIT = "%"
LAYER = "SMT kernel (ops/smt_cuda.py, csrc/smt_encode.cu)"
MOVES = "train_env_steps_per_s"


def read(rec):
    from portbench import harness

    return harness.roofline_share(rec, "smt")
