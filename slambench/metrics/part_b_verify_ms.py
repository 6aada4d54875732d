"""The host's enqueue of Part B's `part_b.verify` span less its child
`part_b.solve` (self time: the 2-D gate, the submap, the masked ICP replay,
acceptance and the masked loop-table writes): the device engine's
`stage_seconds["self.part_b.verify"]`, summed over the window's sessions,
per scan fed. None for a program without the span."""
from slambench.metrics import program_spans

UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = program_spans.LAYER, program_spans.MOVES
KEY = "self.part_b.verify"


def read(ctx):
    return program_spans.per_scan_ms(ctx, KEY)
