"""What the tests of the device engine's Part B on CUDA graphs share (the
CPU's `test_torch_part_b_graphs.py` and the card's `test_torch_cuda.py`):
small sessions that store keyframes, detect, accept loops and run the
in-loop solve, one a loop method (GPS on with "radius"), and the session's
state and results as arrays to compare bit for bit."""

import numpy as np
import torch

from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.io import prefetch as tprefetch
from xchu_slam_tpu_torch.models import device_pipeline as tdp
from xchu_slam_tpu_torch.utils import sim

CAP, CHUNK, KF_POINTS = 8192, 8, 512
BASE = {
    "filter.max_raw_points": CAP, "filter.max_points": 4096,
    "filter.outlier_method": "statistical",
    "ndt.grid_x": 48, "ndt.grid_y": 48, "ndt.grid_z": 16,
    "pgo.max_keyframes": 64, "pgo.max_loops": 8,
    "loop.radius_search": 12.0, "loop.min_time_diff": 0.5, "loop.detect_period": 1,
    "loop.submap_points": 2048, "loop.submap_half_width": 4,
    "loop.icp_fitness_thresh": 1.5, "loop.max_correction": 5.0,
}
# on the CPU each accepts 3-7 loops in 24 scans (10 keyframes)
CASES = {
    "radius_gps": {"loop.method": "radius", "pgo.use_gps": True},
    "sc": {"loop.method": "sc", "sc.num_exclude_recent": 3, "sc.dist_thresh": 0.6,
           "loop.detect_period": 2},
    "isc": {"loop.method": "isc", "isc.skip_neighbor_distance": 3.0,
            "isc.inflation_covariance": 1.0, "isc.geometry_thresh": 0.3,
            "isc.intensity_thresh": 0.3},
}


def config(case: str):
    return tconfig.default_config().override({**BASE, **CASES[case]})


def scans(n: int = 24) -> list:
    """`n` scans along a 15 m circuit: neighbouring keyframes are loop
    candidates for every method above."""
    world = sim.make_world(4, extent=50.0, ground_pts=40_000)
    gt = sim.loop_trajectory(n, radius=15.0, speed=1.0)
    rng = np.random.default_rng(4)
    return [sim.render_scan(world, p, rng, n_points=6000) for p in gt]


def stage(scan_list: list, device) -> list:
    """The scans as staged chunks of CHUNK."""
    stager = tprefetch.ChunkStager(CAP, CHUNK, n_buffers=len(scan_list) // CHUNK + 1,
                                   device=device)
    return [stager.stage(scan_list[lo:lo + CHUNK]) for lo in range(0, len(scan_list), CHUNK)]


def feed(pipe, chunks: list, first_chunk: int = 0) -> None:
    """Chunks `first_chunk`.. of a session, each scan's GPS altitude its
    stamp, missing on every third scan."""
    for c in range(first_chunk, len(chunks)):
        clouds, n_real = chunks[c]
        stamps = 0.1 * (CHUNK * c + np.arange(CHUNK))
        alts = np.where(np.arange(CHUNK) % 3 == 0, np.nan, stamps).astype(np.float32)
        pipe.process_chunk(clouds, stamps, n_real, gps_alts=alts)


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if tree is None or isinstance(tree, int):
        return tree
    return type(tree)(*(clone(t) for t in tree))


def part_b_state(pipe) -> list:
    """Everything Part B writes, before `finalize`: the keyframe store, the
    factor graph, `loop_count`, the diagnostics and the log ring, on the
    host."""
    return [t.cpu().clone() for t in tdp._state_tensors(pipe.state)]


def results(pipe) -> dict:
    """A finalized session: the odometry log (diagnostic columns included),
    the keyframe stores, the loop table, GPS factors and the counters."""
    stamps, odo, opt = pipe.keyframe_trajectory()
    g, db = pipe.graph, pipe.db
    out = {"log": np.array([[*r["pose"], *(float(v) for k, v in r.items() if k != "pose")]
                            for r in pipe.odom_log]),
           "kf_stamps": stamps, "kf_poses": odo, "kf_opt": opt,
           "counts": np.array([pipe.kf_count, pipe.loop_count, pipe.scan_count])}
    for name in ("clouds", "cloud_mask", "sc_db", "isc_db", "travel"):
        out[name] = getattr(db, name).cpu().numpy()
    for name in g._fields:
        out[name] = getattr(g, name).cpu().numpy()
    return out


def assert_equal(a, b) -> None:
    """Two `part_b_state` lists or two `results` dicts, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        pairs = [(key, a[key], b[key]) for key in a]
    else:
        assert len(a) == len(b)
        pairs = [(i, x.numpy(), y.numpy()) for i, (x, y) in enumerate(zip(a, b))]
    for what, x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert x.tobytes() == y.tobytes(), what


def expected_replays(pipe, n_keyframes: int) -> int:
    """Part B's own replays in a session whose keyframes 1..n_keyframes-1 ran
    on the graphs: a chain's first use runs eagerly, after it every store is
    one replay and every detection chain four (three for ISC, whose
    retrieval stays eager)."""
    spec = pipe.spec
    ks = range(1, n_keyframes)
    det = [k for k in ks if spec.method != "none" and k % spec.detect_period == 0]
    per_detect = 3 if spec.method == "isc" else 4
    return max(len(ks) - 1, 0) + per_detect * max(len(det) - 1, 0)
