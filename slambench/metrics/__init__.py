"""One reader a metric: `<metric>.py` holds its UNIT, SOURCE, LAYER and
MOVES (the end-to-end metric it should move; None for an end-to-end
metric) and `read(ctx) -> float | None`, None where the run gives it
nothing to read. `ctx` is the run's record (`harness.run`)."""


def window_chunks(ctx) -> list:
    """The chunks that came back inside the window, in order."""
    return [c for s in ctx["sessions"] for c in s.chunks if not c["late"]]
