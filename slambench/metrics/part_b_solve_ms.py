"""The host's enqueue of Part B's `part_b.solve` span (the in-loop pose-graph
solve, masked by its `run` flag): the device engine's
`stage_seconds["part_b.solve"]`, summed over the window's sessions, per scan
fed. None for a program without the span."""
from slambench.metrics import program_spans

UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = program_spans.LAYER, program_spans.MOVES
KEY = "part_b.solve"


def read(ctx):
    return program_spans.per_scan_ms(ctx, KEY)
