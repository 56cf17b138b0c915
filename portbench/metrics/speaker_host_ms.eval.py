"""Host milliseconds of the instruction source per speaker decode (the neural speaker's
greedy decode, its tokenization into CLIP ids and the memo's lookups): the program's span
``collect.instruction`` over the counter ``speaker.decodes``, over the traced window."""

UNIT = "ms"
LAYER = "Speaker (dialog/instruction_source.py, dialog/speaker/)"
MOVES = "step_ms_p95"


def read(rec):
    span = rec.get("span_totals", {}).get("collect.instruction")
    decodes = rec.get("counters", {}).get("speaker.decodes")
    return span["total_ns"] / decodes / 1e6 if span and decodes else None
