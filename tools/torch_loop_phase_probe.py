#!/usr/bin/env python3
"""Where the loop back end's two kernels spend their time inside, on one GPU.

    python3 tools/torch_loop_phase_probe.py [--kernels first,new] [--steps 4]

Builds `csrc/pgo_kernel.cu` and `csrc/pgo_kernel_first.cu` with `-DPGO_TICKS`,
`csrc/icp_kernel.cu` and `csrc/icp_kernel_first.cu` with `-DICP_TICKS` (the
first thread of the block then leaves the SM's cycle counter at the end of
each phase; these builds are libraries of their own, never the ones the
solve or a verification launches), and prints, for each version named in
`--kernels` (`first`: the kernel's first version, `new`: the one the main
path launches):

  pgo   at K = 2048 slots with `chip_smoke.py`'s two graphs (163 live
        keyframes with 9 loops, 2048 with 40) and the circuit's in-loop spec,
        on the system of the first Gauss-Newton iteration: the cycles of each
        phase summed over one launch (live-prefix scan, scaling, factor, the
        CG set-up, the preconditioner's scaling in, forward substitution,
        block solves, backward substitution, scaling out, Hessian-vector
        product, reductions, vector updates, and what the version adds), and
        the CG iterations
  icp   on `tests/icp_cases.py`'s scene (4096 points against 16,384), a step
        kept live (a negative epsilon never converges): the cycles of each
        phase of the last of `--steps` steps (pass 1, reduction 1, pass 2,
        reduction 2, eigen-solve, update, transform), and the Jacobi sweeps
        the new version's eigen-solve took

Last, with the ordinary builds (no ticks), the new PGO kernel's ms per launch
at both graphs with each substitution forced (the sequential sweep, the
segmented one) beside the source's own choice: what sets the crossover
`kSegmentedMin` in `csrc/pgo_kernel.cu`. Cycles are the first thread's view,
barriers included. The card's name, power limit and SM clocks come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]
import icp_cases  # noqa: E402
import pgo_cases  # noqa: E402
from xchu_slam_tpu_torch import cli  # noqa: E402
from xchu_slam_tpu_torch.models import pose_graph as pg  # noqa: E402
from xchu_slam_tpu_torch.ops import icp  # noqa: E402
from xchu_slam_tpu_torch.ops.cuda import icp_kernel, nn_kernel, pgo_kernel  # noqa: E402
from xchu_slam_tpu_torch.utils import se3  # noqa: E402

PGO_CASES = ((163, 9), (2048, 40))      # chip_smoke.py's PGO_CASES
_PGO_FIRST = ("prefix", "scale", "factor", "init", "prec_in", "forward", "block_solve",
              "backward", "prec_out", "hvp", "reduce", "update")
PGO_PHASES = {"first": _PGO_FIRST, "new": (*_PGO_FIRST, "transfer")}
# live keyframes (loops) at which the forced sweeps are timed
SWEEP_CASES = ((24, 4), (48, 4), (64, 4), (96, 6), (163, 9), (512, 16), (2048, 40))
ICP_PHASES = ("pass1", "reduce1", "pass2", "reduce2", "eigen", "update", "transform")


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """ms per call of `fn()` on the card alone: `calls` calls in one CUDA
    graph, `replays` replays between one pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def pgo_args(n_live: int, n_loops: int, dev):
    """The kernel's arguments for the first Gauss-Newton iteration of a
    `pgo_cases` graph at K = 2048 with the circuit's in-loop spec."""
    spec = pg.inloop_spec(pg.spec_from_config(cli.sim_config().pgo))
    poses, graph = pgo_cases.chain_graph(K=2048, L=256, n_live=n_live, n_loops=n_loops,
                                         gps=True)
    p_d, g_d = torch.from_numpy(poses).to(dev), pgo_cases.to_device(graph, dev)
    s = pg._gn_system(se3.pose_to_matrix(p_d), g_d, spec)
    return (s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(), s.Ji.contiguous(),
            s.Jj.contiguous(), s.odom_info, s.wp, s.Jli.contiguous(), s.Jlj.contiguous(),
            g_d.loop_i, g_d.loop_j, s.wl.contiguous(), s.A.contiguous(), s.gz.contiguous(),
            g_d.kf_mask, torch.ones((), dtype=torch.bool, device=dev),
            spec.cg_tol, spec.cg_iterations)


def read_ticks(read, n: int) -> list[int]:
    """The n cycle slots a `pgo_ticks` / `icp_ticks` entry gives back."""
    torch.cuda.synchronize()
    ticks = np.zeros(n, np.int64)
    if read(ticks.ctypes.data) != 0:
        raise RuntimeError("reading the kernel's cycle counts failed")
    return [int(t) for t in ticks]


def pgo_phases(which: str, dev) -> None:
    lib = pgo_kernel._library_first() if which == "first" else pgo_kernel._library()
    lib.pgo_ticks.argtypes = [ctypes.c_void_p]
    launch = pgo_kernel._cg_first if which == "first" else pgo_kernel.cg
    names = PGO_PHASES[which]
    for n_live, n_loops in PGO_CASES:
        args = pgo_args(n_live, n_loops, dev)
        launch(*args)                     # warm
        _x, iters = launch(*args)
        ticks = read_ticks(lib.pgo_ticks, len(names))
        row = {"kernel": "pgo", "version": which, "live": n_live, "loops": n_loops,
               "cg_iterations": int(iters), "cycles": dict(zip(names, ticks)),
               "total_cycles": sum(ticks)}
        print(json.dumps(row))


def icp_phases(which: str, dev, steps: int) -> None:
    lib = icp_kernel._library_first() if which == "first" else icp_kernel._library()
    lib.icp_ticks.argtypes = [ctypes.c_void_p]
    step = icp_kernel._step_first if which == "first" else icp_kernel.step
    src, smask, tgt, tmask, init = icp_cases.scene(dev)
    spec = icp.IcpSpec()
    st = torch.zeros(icp_kernel.STATE_FLOATS, device=dev)
    cur = torch.empty_like(src)
    icp_kernel.init(src, init, torch.ones((), dtype=torch.bool, device=dev), st, cur)
    for _ in range(steps):
        idx, d2 = nn_kernel.nearest_neighbor(cur, tgt, tmask)
        step(src, smask, tgt, idx, d2, cur, st, spec.max_corr_dist ** 2, -1.0, 1 << 30)
    n = len(ICP_PHASES) + (1 if which == "new" else 0)
    ticks = read_ticks(lib.icp_ticks, n)
    row = {"kernel": "icp_step", "version": which, "points": int(src.shape[0]),
           "steps": steps, "cycles": dict(zip(ICP_PHASES, ticks)),
           "total_cycles": sum(ticks[:len(ICP_PHASES)])}
    if which == "new":
        row["jacobi_sweeps"] = ticks[-1]
    print(json.dumps(row))


def sweep_timings(dev) -> None:
    """ms per launch of the new kernel (ordinary build) with the
    substitutions forced sequential and segmented, and as the source picks."""
    for n_live, n_loops in SWEEP_CASES:
        args = pgo_args(n_live, n_loops, dev)
        row = {"kernel": "pgo", "live": n_live, "loops": n_loops,
               "segment_links": pgo_kernel._library().pgo_segment_links(n_live)}
        for name, fn in (("sequential_ms", lambda: pgo_kernel._cg_sweep(*args, 1 << 30)),
                         ("segmented_ms", lambda: pgo_kernel._cg_sweep(*args, 0)),
                         ("kernel_ms", lambda: pgo_kernel.cg(*args))):
            row[name] = graph_ms(fn)
        print(json.dumps(row))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="first,new")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe times CUDA kernels")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    kinds = args.kernels.split(",")
    if "new" in kinds:
        sweep_timings(dev)
        pgo_kernel._library.cache_clear()
        icp_kernel._library.cache_clear()
    # the instrumented builds are libraries of their own (flags are part of the key)
    pgo_kernel.NVCC_FLAGS = (*pgo_kernel.NVCC_FLAGS, "-DPGO_TICKS")
    icp_kernel.NVCC_FLAGS = (*icp_kernel.NVCC_FLAGS, "-DICP_TICKS")
    for which in kinds:
        pgo_phases(which, dev)
        icp_phases(which, dev, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
