"""Host milliseconds of pi_l's act per acting step (its towers, SMT, dialog state encoder
and heads; the CLIP tower is not in it): the program's span ``collect.dialog`` over the
traced window, its total over its count."""

UNIT = "ms"
LAYER = "Policies (models/option_policy.py, models/dialog_policy.py)"
MOVES = "step_ms_p95"


def read(rec):
    span = rec.get("span_totals", {}).get("collect.dialog")
    return span["total_ns"] / span["count"] / 1e6 if span and span["count"] else None
