"""Model FLOPs of the traced window's rounds (counted on the reference modules at the cell's
shapes: trained layers' backward twice their forward, frozen towers forward only) over
the window's time x 989 TFLOP/s, the H100's dense bf16 peak."""

UNIT = "%"
LAYER = "Whole step"
MOVES = "train_env_steps_per_s"


def read(rec):
    from portbench import harness

    f, s = rec.get("flops_per_round"), rec.get("window_s")
    if not f or not s:
        return None
    return 100.0 * f * rec["rounds"] / (s * harness.PEAK["bf16"])
