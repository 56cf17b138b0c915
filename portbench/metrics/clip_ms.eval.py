"""Device-stream milliseconds of one call of the frozen CLIP text tower (12 layers over
77 positions, the rows of the step where a query starts): the stream time of the
program's span ``collect.clip`` over the counter ``clip.calls``, over the traced window."""

UNIT = "ms"
LAYER = "CLIP text tower (models/clip_text.py)"
MOVES = "step_ms_p95"


def read(rec):
    span = rec.get("span_totals", {}).get("collect.clip")
    calls = rec.get("counters", {}).get("clip.calls")
    if not span or "stream_ns" not in span or not calls:
        return None
    return span["stream_ns"] / calls / 1e6
