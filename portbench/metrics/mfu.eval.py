"""Model FLOPs of the traced window (counted on the reference modules at the cell's shapes:
pi_q, pi_g, pi_l and both belief towers for every env row of every acting step, the CLIP
tower for each row it embedded, the speaker for each decode) over the window's time x
989 TFLOP/s, the H100's dense bf16 peak."""

UNIT = "%"
LAYER = "Whole step"
MOVES = "step_ms_p95"


def read(rec):
    from portbench import harness

    f, s = rec.get("flops_window"), rec.get("window_s")
    if not f or not s:
        return None
    return 100.0 * f / (s * harness.PEAK["bf16"])
