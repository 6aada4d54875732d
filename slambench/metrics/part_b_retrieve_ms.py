"""The host's enqueue of Part B's `part_b.retrieve` span (`_detect_candidate`:
a detection's retrieval; its count is the detections): the device engine's
`stage_seconds["part_b.retrieve"]`, summed over the window's sessions, per
scan fed. None for a program without the span."""
from slambench.metrics import program_spans

UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = program_spans.LAYER, program_spans.MOVES
KEY = "part_b.retrieve"


def read(ctx):
    return program_spans.per_scan_ms(ctx, KEY)
