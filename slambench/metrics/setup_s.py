"""Process start to the first timed hand-off: CUDA start-up, the kernels
loaded (built on a checkout's first run), the world and the lap rendered,
the window's scans drawn, the warm session."""
UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", None, None


def read(ctx):
    return ctx["setup_s"]
