"""The SMT encode kernel's share of its roofline over the profiled collect, at AVLEN's three
shapes (pi_g over 151 entries of 288, pi_q over 151 of 320, pi_l over 4 of 288): the least
time for its launches (operations counted once, against TF32 dense) over its kernels'
device time."""

UNIT = "%"
LAYER = "SMT kernel (ops/smt_cuda.py, csrc/smt_encode.cu)"
MOVES = "step_ms_p95"


def read(rec):
    from portbench import harness

    return harness.roofline_share(rec, "smt")
