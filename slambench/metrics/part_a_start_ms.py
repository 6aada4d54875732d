"""A session's start inside the program: the device engine's host seconds
in `session.seed` (`init_state`), `part_a.eager` (the first scan, run
eagerly) and `part_a.capture` (Part A's CUDA graph captured), summed a
session, mean over the window's sessions that seeded. None for a program
without these spans."""
import numpy as np

from slambench.metrics import program_spans

UNIT, SOURCE = "ms", "program_span"
LAYER, MOVES = program_spans.LAYER, program_spans.MOVES
KEYS = ("session.seed", "part_a.eager", "part_a.capture")


def read(ctx):
    t = [sum(s.stage_seconds.get(k, 0.0) for k in KEYS) for s in ctx["sessions"]
         if s.stage_seconds and KEYS[0] in s.stage_seconds]
    return 1e3 * float(np.mean(t)) if t else None
