"""Live ICP trips over the icp_step launches of the window, in %: the
program's `icp.live_trip_count()` and `icp_kernel.launches` (a verification
replays 100 trips, and the trips after it has stopped return at once)."""
UNIT, SOURCE = "%", "program_counter"
LAYER, MOVES = "loop closure (ops/icp.py)", "chunk_latency_p95_ms"


def read(ctx):
    c0, c1 = ctx["counters"]
    launches = c1["icp_step"] - c0["icp_step"]
    live = c1["icp_live_trips"] - c0["icp_live_trips"]
    return 100.0 * live / launches if launches and live else None
