#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`xchu_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; fails if there is no CUDA device or TF32 is on
  2. build    nvcc-compiles the four kernel sources (csrc/nn_kernel.cu,
              ndt_kernel.cu, pgo_kernel.cu, icp_kernel.cu, sm_90a) and the
              PGO and ICP kernels' first versions (pgo_kernel_first.cu,
              icp_kernel_first.cu), one nvcc each, started together; prints
              ptxas's registers, shared memory and spills (none allowed but in
              the NDT kernel)
  3. kernel   the NN kernel against its first version (idx and d² bit-equal)
              and its plain PyTorch version (d² to rtol = atol = 1e-4, valid
              indices, ties at the lowest index) on the card, over shapes and
              masks that walk the edges of its split of the targets; then
              the wrapper's host cost and, at the ICP shape 4096 × 16384, ms
              per launch over many launches per CUDA-event pair, in turns:
              first version, kernel, kernel, first version, plain, library
  4. ndt_kernel  the NDT align kernel against its plain version
              (`ndt.align_ref`) on the state of the circuit's first scans at
              full width: one pass ((L, g, H) within 1e-5 of the largest
              entry), then 64 whole aligns, each from the host engine's own
              state and guess (|Δpose| ≤ 1e-4 on every one, the same
              iteration count on ≥ 9 in 10, reruns bit-identical); ms per
              align and per single pass from CUDA-graph replays, beside the
              plain version on the host's clock; then what an align waits
              for, each timed alone on a line of its own (an empty
              cooperative launch, grid and cluster barriers, a dependent L2
              load, the control step) and the latency floor they add up to
  5. main     the `run-sim` host engine on the 430-scan, 55 m circuit at
              the default config; needs NN kernel launches ≥ 1, NDT kernel
              launches ≥ one a scan, loops ≥ 1 and aligned ATE < 1.0 m
  6. session  the sensor-aided mapping session through the CLI's functions,
              in a temporary directory: `run-sim` on the same circuit with
              ISC loops, IMU + wheel + GPS inputs and a checkpoint every 200
              scans (needs NN launches ≥ 1, NDT launches ≥ one a scan, loops
              ≥ 1, aligned ATE < 1.0 m);
              every export file read back; `eval` of the exported trajectory
              against a ground-truth TUM file within 1e-3 of the run's own
              ATE; `localize` of 12 fresh scans against the checkpoint read
              from disk (≥ 1 found, median error of the found < 1.5 m, NN
              launches ≥ 1); the checkpoint resumed for 5 scans, poses
              bit-identical to the uninterrupted run's
  7. determinism  the first 60 scans twice from a fresh state: per-scan
              poses bit-identical
  8. device   the device engine (`models/device_pipeline.py`): the
              circuit's 27 chunks staged in this thread, Part A and Part B,
              under `torch.cuda.set_sync_debug_mode("error")` (one eager scan,
              the capture, CUDA-graph replays, one readback a chunk, the loop
              back end on the card); launches, synchronisations, kernels and
              the card's busy share over 4 warm chunks and over Part A alone
              (torch.profiler); `run-sim --engine device --chunk 16` on the
              circuit with `--out` (keyframes within ±2 of the host
              engine's, loops ≥ 1, aligned ATE < 0.10 m, NDT launches ≥ one a
              scan, the export read back), its rate beside the host
              engine's of phase 5; a 64-scan run with the radius retrieval
              and GPS factors; 64 scans twice, poses bit-identical
Between phases 4 and 5, two more kernel phases:
  4b. pgo_kernel  `pose_graph.solve` on the card against `solve_ref` at the
              circuit's in-loop spec on 2048 slots, 163 live keyframes with 9
              loops and 2048 with 40 (|Δpose| ≤ 1e-4, reruns bit-identical);
              ms per launch from CUDA-graph replays, in turns with the
              kernel's first version (first, kernel, kernel, first), beside
              its bound and two latency floors from the source's probe
              kernels: the first version's (launch, block barriers, n factor
              links in one thread, 2·n substitution links a preconditioner)
              and the segmented structure's (n factor links of this kernel's
              faster form, 2·Lseg + S segment links a sweep, the transfer
              products); the
              plain factor + CG and both whole solves on the host's clock
  4c. icp_kernel  the verification's CUDA graph (NN kernel + icp_step)
              against `align_ref` at 4096 × 16384 (T to 1e-5, the same
              iteration count, reruns bit-identical); icp_step's ms per launch
              in turns with its first version, a verification's, a dead
              trip's (the three kernels of a finished trip), the bound and the
              floor (launch, barriers and the eigen-solve, timed alone)
Phases 5-8 also assert that every path with a verification launched
icp_step and every accepted loop the PGO kernel; phase 8 runs the whole
circuit, Part B included, under `set_sync_debug_mode("error")` with one
readback a chunk, and checks `chunk_readbacks` of `run-sim --engine device`.
Then one JSON line of kernel records (all four kernels, with the launches of
each path) and, last, the result line. `--kernel-only` stops after phase 3,
`--kernels-only` after phase 4c, `--device-only` runs phases 1, 2, 5 and 8;
none of the three prints a result line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SCANS, RADIUS, SEED = 430, 55.0, 0
DET_SCANS = 60
CHECKPOINT_EVERY, RESUME_SCANS, QUERIES = 200, 5, 12
FITNESS_THRESH = 1.5     # `localize`'s ICP gate for one sparse sim scan
TOL = 1e-4
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# mangled-name fragments of csrc/nn_kernel.cu's kernels, and what they are
PTXAS_NAMES = (("nn_kernel_simple", "first version"),
               ("nn_merge_kernel", "merge"),
               ("nn_kernel", "scan"),
               ("ndt_align_kernel", "ndt align"),
               ("pgo_cg_kernel", "pgo"),
               ("pgo_cg_first_kernel", "pgo first version"),
               ("icp_step_kernel", "icp step"),
               ("icp_step_first_kernel", "icp step first version"),
               ("icp_init_kernel", "icp init"),
               ("icp_fitness_kernel", "icp fitness"))   # the probe kernels are not listed


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    import xchu_slam_tpu_torch  # noqa: F401  (sets the TF32 switches)

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> dict:
    """Build the kernels, one nvcc per source, all started together; print
    what ptxas says of each (registers, shared memory, spills) and fail on a
    spill."""
    from concurrent.futures import ThreadPoolExecutor

    from xchu_slam_tpu_torch.ops.cuda import icp_kernel, ndt_kernel, nn_kernel, pgo_kernel

    builds = (nn_kernel.build, ndt_kernel.build, pgo_kernel.build, pgo_kernel.build_first,
              icp_kernel.build, icp_kernel.build_first)
    with ThreadPoolExecutor(len(builds)) as pool:
        builds = [pool.submit(b) for b in builds]
        builds = [b.result() for b in builds]
    figures = {}
    for lib, secs, log in builds:
        print(f"build: {lib.name} in {secs:.2f} s")
        print(log.strip(), file=sys.stderr)
        for entry, spill, regs, rest in re.findall(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                r"Used (\d+) registers([^\n]*)", log, re.S):
            name = next((n for tag, n in PTXAS_NAMES if tag in entry), None)
            if name is None:
                continue
            smem = re.search(r"(\d+) bytes smem", rest)
            figures[name] = {"registers": int(regs),
                             "smem_bytes": int(smem.group(1)) if smem else 0,
                             "spill_bytes": int(spill)}
    print("ptxas: " + json.dumps(figures))
    if set(figures) != {n for _tag, n in PTXAS_NAMES}:
        raise AssertionError("ptxas reported no figures for a kernel")
    if any(f["spill_bytes"] for n, f in figures.items() if n != "ndt align"):
        raise AssertionError("an NN, PGO or ICP kernel spills registers")
    return figures


def _loop_ms(fn, calls: int, warmup: int = 3) -> float:
    """ms per call of `fn()`: `calls` calls between one pair of CUDA events.
    Right for work that keeps the card busier than the host needs to
    enqueue it."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _graph_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """ms per call of `fn()` on the card alone: `calls` calls captured into
    one CUDA graph, `replays` replays between one pair of CUDA events. The
    host enqueues nothing inside the timed window, so a kernel shorter than
    its wrapper's host cost is still timed on the device."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def _host_us(fn, calls: int = 1000) -> float:
    """Host µs per call of `fn()`: the host clock over `calls` enqueues
    without a sync (then one sync, outside the window); the median of 5."""
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


# FP32 instructions per (source, target) pair. The fewest any correct version
# needs: |t|² − 2s·t with |t|² and −2t precomputed is 3 FMAs, then a compare
# and a select (the exact d² is recomputed for the winner alone, as the TPU
# kernel and the plain version do). The kernel's own arithmetic, the direct
# difference that keeps it bit-equal to its first version: 3 subtractions,
# 1 multiply, 2 FMAs, a compare and a select.
MIN_INSTR_PER_PAIR = 5
DIRECT_INSTR_PER_PAIR = 8


def nn_bound_ms(n: int, m: int) -> tuple[float, str, float]:
    """The least time the card could take for one call, what bounds it, and
    the least the kernel's direct-difference arithmetic could take.
    Bytes: every input read once, every output written once, at 3.35 TB/s.
    Operations: `MIN_INSTR_PER_PAIR` FP32 instructions per pair at the issue
    rate behind the card's 67 TFLOP/s FP32 peak, which counts an FMA as 2:
    33.5 T instructions/s."""
    bytes_ms = 1e3 * (12 * n + 13 * m + 8 * n) / HBM_BYTES_PER_S
    ops_ms = 1e3 * (MIN_INSTR_PER_PAIR * n * m) / (FP32_FLOPS / 2)
    direct_ms = 1e3 * (DIRECT_INSTR_PER_PAIR * n * m) / (FP32_FLOPS / 2)
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations",
            max(bytes_ms, direct_ms))


def phase_kernel() -> dict:
    import nn_cases  # tests/nn_cases.py: the inputs the tests use too
    from xchu_slam_tpu_torch.ops.cuda import nn_kernel

    dev = torch.device("cuda")
    cases = nn_cases.edge_cases(np.random.default_rng(7))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    for name, s, t, msk in cases:
        s_d, t_d = torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)
        m_d = torch.from_numpy(msk).to(dev)
        idx, d2 = nn_kernel.nearest_neighbor(s_d, t_d, m_d)
        old_idx, old_d2 = nn_kernel._nearest_neighbor_simple(s_d, t_d, m_d)
        _ref_idx, ref_d2 = nn_kernel.nearest_neighbor_ref(s_d, t_d, m_d)
        torch.cuda.synchronize()
        split = nn_kernel.plan(len(s), len(t), sms)
        if not (torch.equal(idx, old_idx) and torch.equal(d2, old_d2)):
            bad = int(((idx != old_idx) | (d2 != old_d2)).sum())
            raise AssertionError(f"{name} (split {split}): {bad} rows differ "
                                 "from the first version of the kernel")
        idx, d2, ref_d2 = idx.cpu().numpy(), d2.cpu().numpy(), ref_d2.cpu().numpy()
        if msk.any():
            if not msk[idx].all():
                raise AssertionError(f"{name}: an index points at a masked target")
            exact = ((s - t[idx]) ** 2).sum(-1)
            np.testing.assert_allclose(d2, exact, rtol=TOL, atol=TOL)
            # ties keep the lowest index: the first valid copy of the picked point
            first = np.array([np.flatnonzero(msk & (t == t[j]).all(-1))[0]
                              for j in idx[:64]])
            if not (first == idx[:64]).all():
                raise AssertionError(f"{name}: a tie did not keep the lowest index")
        elif not ((idx == 0).all() and (d2 == 1e30).all()):
            raise AssertionError(f"{name}: an all-masked row must give (0, 1e30)")
        np.testing.assert_allclose(d2, ref_d2, rtol=TOL, atol=TOL, err_msg=name)
        max_err = max(max_err, float(np.abs(d2 - ref_d2).max()))
    print(f"kernel: {len(cases)} cases bit-equal to the first version and within "
          f"rtol=atol={TOL} of the plain version (max |Δd²| {max_err:.3g})")

    name, s, t, msk = cases[0]
    s_d, t_d, m_d = (torch.from_numpy(a).to(dev) for a in (s, t, msk))

    def new():
        return nn_kernel.nearest_neighbor(s_d, t_d, m_d)

    def simple():
        return nn_kernel._nearest_neighbor_simple(s_d, t_d, m_d)

    def plain():
        return nn_kernel.nearest_neighbor_ref(s_d, t_d, m_d)

    def library():  # the closest PyTorch composition; the port never calls it
        return torch.cdist(s_d, t_d).min(dim=1)

    host_us, simple_host_us = _host_us(new), _host_us(simple)
    print(f"kernel: wrapper host cost {host_us:.2f} us per call, first version "
          f"{simple_host_us:.2f} us (1000 enqueues, no sync, median of 5); "
          f"split {nn_kernel.plan(len(s), len(t), sms)} on {sms} SMs")
    # simple, new, new, simple, then plain and library: means of each pair
    o1, k1, k2, o2 = (_graph_ms(simple), _graph_ms(new), _graph_ms(new),
                      _graph_ms(simple))
    loop_ms = _loop_ms(new, 200)
    plain_ms = _loop_ms(plain, 20)
    library_ms = _loop_ms(library, 20)
    ms, simple_ms = 0.5 * (k1 + k2), 0.5 * (o1 + o2)
    bound_ms, bound_by, direct_bound_ms = nn_bound_ms(len(s), len(t))
    print(f"kernel: {name} {ms:.5f} ms per launch on the card "
          f"(graph replays {k1:.5f}/{k2:.5f}), bound {bound_ms:.5f} ms by "
          f"{bound_by} at {MIN_INSTR_PER_PAIR} FP32 instructions per pair "
          f"({100 * bound_ms / ms:.1f} % of it reached; "
          f"{direct_bound_ms:.5f} ms at the {DIRECT_INSTR_PER_PAIR} of the "
          f"kernel's direct difference), first version {simple_ms:.5f} ms "
          f"({o1:.5f}/{o2:.5f}), {simple_ms / ms:.2f}x; {loop_ms:.5f} ms per "
          f"call enqueued from the host (200 calls per event pair); plain "
          f"{plain_ms:.5f} ms; library (cdist then min, two calls, mask "
          f"ignored) {library_ms:.5f} ms")
    if not ms < simple_ms:
        raise AssertionError("the kernel is no faster than its first version")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "direct_bound_ms": direct_bound_ms, "library_ms": library_ms,
            "simple_ms": simple_ms, "loop_ms": loop_ms, "host_us": host_us}


# FP32 operations of the NDT kernel's passes, per source point with 7 valid
# neighbours (a multiply-add counts 2): the Hessian pass forms Bδ, δᵀBδ, the
# exponential, a6 and the 21 + 9 running sums per pair (~75 multiply-adds each)
# and J-terms once per point (~150); the gradient pass ~30 per pair and ~40
# per point; the fitness pass ~6 per pair.
NDT_FLOP_HESS = 2 * (7 * 75 + 150)
NDT_FLOP_GRAD = 2 * (7 * 30 + 40)
NDT_FLOP_FIT = 2 * (7 * 6 + 10)
NDT_ALIGNS = 64
NDT_POSE_TOL = 1e-4      # m and rad, per align from the host engine's own state
NDT_PASS_TOL = 1e-5      # of the largest |entry| of (L, g, H): the sums' order differs


def ndt_bound_ms(n: int, iterations: float, trials: float) -> tuple[float, str, float, float]:
    """The least time the card could take for one align with this run's trip
    counts: bytes (source points, mask and the 7 gathered rows of each point
    read once, the record written once) at 3.35 TB/s against the passes' FP32
    operations at 67 TFLOP/s. Returns (bound, what bounds it, bytes ms,
    operations ms). Neither reaches a microsecond: what the kernel really
    waits for is latency, which `ndt_latency_floor` measures."""
    bytes_ms = 1e3 * (n * 12 + n + n * 7 * 40 + 64 * 4) / HBM_BYTES_PER_S
    flop = n * (iterations * NDT_FLOP_HESS + trials * NDT_FLOP_GRAD + NDT_FLOP_FIT)
    ops_ms = 1e3 * flop / FP32_FLOPS
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations",
            bytes_ms, ops_ms)


PROBE_CALLS = 20         # probe launches per CUDA graph
CHASE_HOPS = 256
CONTROL_STEPS = 8


def ndt_latency_floor(smi: str, n: int, sums: torch.Tensor, nspec, d2: float,
                      iterations: int, passes: int) -> dict:
    """What an align waits for, each timed alone from CUDA-graph replays of
    the kernel source's probe kernels and printed with the card: an empty
    cooperative launch, `grid.sync()` on 64 blocks × 128 threads, at this
    kernel's geometry and on every SM, `cluster.sync()` in one cluster of 8 and of 16
    blocks, one dependent load from L2, one control step of a Hessian pass.
    The floor of an align of p passes, i of them Hessian passes, is
    launch + p × (barrier + one L2 round trip) + i × control."""
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, _trips = ndt_kernel.plan(n, ndt_kernel.max_blocks(0))
    threads = ndt_kernel.THREADS

    def timed(kind, reps, **kw):
        return _graph_ms(lambda: ndt_kernel.probe(kind, reps, **kw), calls=PROBE_CALLS)

    out = {}
    for name, b, t in (("64x128", 64, 128), (f"{blocks}x{threads}", blocks, threads),
                       (f"{sms}x{threads}", sms, threads)):
        t0, t1, t5 = (timed("grid", r, blocks=b, threads=t) for r in (0, 1, 5))
        out[f"grid {name}"] = {"launch_ms": t0, "one_sync_ms": t1, "five_syncs_ms": t5,
                               "barrier_ms": (t5 - t1) / 4}
        print(f"floor [{smi}]: cooperative launch of {name}: empty {t0:.5f} ms, "
              f"1 grid.sync {t1:.5f} ms, 5 grid.sync {t5:.5f} ms: "
              f"{(t5 - t1) / 4:.5f} ms a barrier")
    for cluster in (8, 16):
        held = ndt_kernel.probe_max_clusters(cluster, threads)
        if held < 1:
            out[f"cluster {cluster}x{threads}"] = None
            print(f"floor [{smi}]: one cluster of {cluster} x {threads}: the card "
                  "places none")
            continue
        t0, t1, t5 = (timed("cluster", r, blocks=cluster, threads=threads)
                      for r in (0, 1, 5))
        out[f"cluster {cluster}x{threads}"] = {
            "launch_ms": t0, "one_sync_ms": t1, "five_syncs_ms": t5,
            "barrier_ms": (t5 - t1) / 4, "held_at_once": held}
        print(f"floor [{smi}]: one cluster of {cluster} x {threads} ({held} held at "
              f"once): empty {t0:.5f} ms, 1 cluster.sync {t1:.5f} ms, 5 cluster.sync "
              f"{t5:.5f} ms: {(t5 - t1) / 4:.5f} ms a barrier")
    # a table the size of the voxel table (6 MB, L2-resident after the warm-up
    # replay); every hop lands on another line
    size = 1_536_000
    nxt = ((torch.arange(size, device=dev, dtype=torch.int64) + 40_961) % size).to(torch.int32)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    c0, c1 = (timed("chase", h, inp=nxt, out=sink) for h in (0, CHASE_HOPS))
    hop_ms = (c1 - c0) / CHASE_HOPS
    out["l2_hop_ms"] = hop_ms
    print(f"floor [{smi}]: {CHASE_HOPS} dependent L2 loads in one thread {c1:.5f} ms, "
          f"none {c0:.5f} ms: {hop_ms:.6f} ms a round trip")
    step = torch.zeros(6, device=dev)
    kw = dict(inp=sums, out=step, two_s=-d2, step_size=nspec.step_size)
    s1, s9 = (timed("control", r, **kw) for r in (1, 1 + CONTROL_STEPS))
    control_ms = (s9 - s1) / CONTROL_STEPS
    torch.cuda.synchronize()
    if not bool(torch.isfinite(step).all()) or not float(step.abs().max()) > 0:
        raise AssertionError(f"the control probe gave no step: {step.cpu().numpy()}")
    out["control_ms"] = control_ms
    print(f"floor [{smi}]: control step of a Hessian pass in one warp: 1 step "
          f"{s1:.5f} ms, {1 + CONTROL_STEPS} steps {s9:.5f} ms: {control_ms:.5f} ms a step")
    mine = out[f"grid {blocks}x{threads}"]
    floor_ms = (mine["launch_ms"] + passes * (mine["barrier_ms"] + hop_ms)
                + iterations * control_ms)
    out.update(floor_ms=floor_ms, passes=passes, hessian_passes=iterations,
               geometry=f"{blocks}x{threads}")
    print(f"floor [{smi}]: an align of {passes} passes ({iterations} Hessian): launch "
          f"{mine['launch_ms']:.5f} + {passes} x (barrier {mine['barrier_ms']:.5f} + L2 "
          f"round trip {hop_ms:.6f}) + {iterations} x control {control_ms:.5f} = "
          f"{floor_ms:.5f} ms")
    return out


def phase_ndt_kernel(smi: str) -> dict:
    """The NDT align kernel against its plain version (`ndt.align_ref`) on the
    state of the circuit's first scans: one pass, then whole aligns, each from
    the host engine's own state and guess; its times, and the latency floor."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.ops import ndt, ndt_deriv
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import make_cloud
    from xchu_slam_tpu_torch.utils import sim

    dev = torch.device("cuda")
    cfg = cli.sim_config()
    _stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    rng = np.random.default_rng(SEED)
    ospec = odometry.spec_from_config(cfg)
    g, nspec = ospec.gspec, ospec.nspec
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    slot = ndt_kernel.RECORD

    def filtered(i):
        xyz, inten = sim.render_scan(world, gt[i], rng, n_points=24_000)
        return filter_scan(make_cloud(xyz, inten, capacity=cfg.filter.max_raw_points,
                                      device=dev), cfg.filter)

    f0 = filtered(0)
    state = odometry.init_state(ospec, torch.zeros(6, device=dev), f0.xyz, f0.mask)
    max_dpose, same_iters, pass_err, rows = 0.0, 0, None, []
    for i in range(1, NDT_ALIGNS + 1):
        filt = filtered(i)
        guess = odometry._guess(state)
        grid = state.grid_a
        args = (state.grid_a.fin, state.grid_a.origin, filt.xyz, filt.mask, guess,
                g, nspec, d1, d2)
        if i == 1:
            # one pass: (L, g, H) of the kernel against the plain pass
            L, gr, H = ndt_kernel.hessian_pass(*args)
            Lp, gp, Hp = ndt_deriv.ndt_value_grad_hess(
                guess, filt.xyz, filt.mask, state.grid_a, g, d1, d2)
            torch.cuda.synchronize()
            got = torch.cat([L.reshape(1), gr, H.reshape(36)]).cpu().numpy()
            want = torch.cat([Lp.reshape(1), gp, Hp.reshape(36)]).cpu().numpy()
            pass_err = float(np.abs(got - want).max() / np.abs(want).max())
            if not np.isfinite(got).all() or pass_err > NDT_PASS_TOL:
                raise AssertionError(f"ndt pass: (L, g, H) off by {pass_err:.3g} of "
                                     f"the largest entry (> {NDT_PASS_TOL})")
        rec = ndt_kernel.align_record(*args)
        again = ndt_kernel.align_record(*args)
        torch.cuda.synchronize()
        if not torch.equal(rec, again):
            raise AssertionError(f"ndt align {i}: a rerun is not bit-identical: "
                                 f"{rec.cpu().numpy()} against {again.cpu().numpy()}")
        want = ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec)
        rec_h = rec.cpu().numpy()
        dpose = float(np.abs(rec_h[slot["pose"]] - want.pose.cpu().numpy()).max())
        max_dpose = max(max_dpose, dpose)
        same_iters += int(rec_h[slot["iterations"]]) == int(want.iterations)
        rows.append((int(rec_h[slot["iterations"]]), int(rec_h[slot["trials"]]),
                     int(rec_h[slot["passes"]])))
        if not np.isfinite(rec_h[:12]).all() or dpose > NDT_POSE_TOL:
            raise AssertionError(f"ndt align {i}: |Δpose| {dpose:.3g} against the "
                                 f"plain version (> {NDT_POSE_TOL}); record {rec_h[:12]}")
        # the host engine's step (its align is the kernel's) carries the state on
        state, _out = odometry.step(state, filt.xyz, filt.mask, ospec)
    if same_iters < 0.9 * NDT_ALIGNS:
        raise AssertionError(f"ndt align: only {same_iters} of {NDT_ALIGNS} aligns "
                             "took the plain version's iteration count")
    iters = float(np.mean([r[0] for r in rows]))
    trials = float(np.mean([r[1] for r in rows]))
    print(f"ndt_kernel: one pass within {pass_err:.3g} of the largest entry; "
          f"{NDT_ALIGNS} aligns from the host engine's state: max |Δpose| "
          f"{max_dpose:.3g}, same iteration count on {same_iters}, reruns "
          f"bit-identical; mean {iters:.3f} Newton iterations and {trials:.3f} "
          f"line-search trials an align")

    # times on the last align's inputs, from CUDA-graph replays (a cooperative
    # launch is captured like any other); the plain version on the host's clock
    ms = _graph_ms(lambda: ndt_kernel.align_record(*args), calls=20)
    pass_ms = _graph_ms(lambda: ndt_kernel.hessian_pass(*args), calls=20)
    last = rows[-1]
    passes = last[2]
    plain_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    plain_ms = 1e3 * float(np.median(plain_s))
    host_us = _host_us(lambda: ndt_kernel.align_record(*args), calls=200)
    n = int(filt.xyz.shape[0])
    bound_ms, bound_by, bytes_ms, ops_ms = ndt_bound_ms(n, last[0], last[1])
    blocks, trips = ndt_kernel.plan(n, ndt_kernel.max_blocks(0))
    print(f"ndt_kernel [{smi}]: {ms:.5f} ms per align on the card ({last[0]} "
          f"iterations, {last[1]} trials, {passes} passes and barriers: the accepted "
          f"trial gave the fitness sums on {sum(r[2] == r[0] + r[1] for r in rows)} of "
          f"{NDT_ALIGNS}; {blocks} blocks "
          f"x {ndt_kernel.THREADS} threads, {trips} trip), {pass_ms:.5f} ms per launch "
          f"of one Hessian pass; bound {bound_ms:.5f} ms by {bound_by} (bytes "
          f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms: {100 * bound_ms / ms:.1f} % "
          f"of it reached); wrapper host cost {host_us:.2f} us; plain version "
          f"{plain_ms:.3f} ms for the same align on the host's clock (median of 5, a "
          f"readback per pass)")
    # the sums of the last align's last Hessian pass feed the control probe
    sums = torch.zeros(ndt_kernel.ACC, device=dev)
    sums[0] = rec[slot["L"]]
    sums[1:7] = rec[slot["g"]] / (-d2)
    Hm = rec[slot["H"]].reshape(6, 6)
    sums[7:] = Hm[torch.triu(torch.ones(6, 6, dtype=torch.bool, device=dev))]
    floor = ndt_latency_floor(smi, n, sums, nspec, d2, last[0], passes)
    print(f"ndt_kernel [{smi}]: latency floor {floor['floor_ms']:.5f} ms for this "
          f"align: {100 * floor['floor_ms'] / ms:.1f} % of it reached")
    return {"max_abs_err": max_dpose, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "pass_ms": pass_ms, "pass_rel_err": pass_err, "host_us": host_us,
            "same_iterations": same_iters, "aligns": NDT_ALIGNS,
            "mean_iterations": iters, "mean_trials": trials,
            "latency_floor_ms": floor["floor_ms"], "floor": floor}


PGO_CASES = (("circuit", 163, 9), ("capacity", 2048, 40))   # (name, live keyframes, loops)
PGO_TOL = 1e-4            # m and rad: the kernel's sweeps and sums against the plain loop's
# the graph route against align_ref on the same inputs: rotation entries to
# 1e-5, translations to 1e-5 of the source cloud's lever arm max(1 m, max |s|)
# (t = μt − R μs carries R's last-bit differences times the centroid's
# distance, tens of metres on the circuit)
ICP_TOL = 1e-5


def _lever(src, mask) -> float:
    return max(1.0, float(torch.linalg.norm(src[mask], dim=1).max()))
# FP32 operations the PGO kernel does per live keyframe (a multiply-add counts
# 2): the factor link (two triangular solves of six columns, the Schur
# update, the Cholesky: ~700 multiply-adds) once, and per CG iteration the
# Hessian-vector product (four 6×6 products), the two substitution links, the
# block's Cholesky solve and the vector updates (~260)
PGO_FLOP_FACTOR = 2 * 700
PGO_FLOP_ITER = 2 * 260
# bytes per live keyframe the kernel must read once: D, U, Ji, Jj (4 × 144),
# g, the altitude row, weights and flags; per loop slot the two Jacobians
PGO_BYTES_KF = 4 * 144 + 24 + 12 + 4 + 4 + 1
PGO_BYTES_LOOP = 2 * 144 + 16 + 4
# block barriers of a solve by the first version: 16 a CG iteration (3 in the
# Hessian-vector product, 3 in each dot product, 5 in the preconditioner, 2
# updates) and 22 outside the loop
PGO_BARRIERS_ITER, PGO_BARRIERS_FIXED = 16, 22
# ... and by the kernel with segmented sweeps: 19 a CG iteration (2 in the
# Hessian-vector product, 3 in each dot product, 9 in the preconditioner, 2
# updates) and 26 outside the loop
PGO_SEG_BARRIERS_ITER, PGO_SEG_BARRIERS_FIXED = 19, 26


def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of `fn()` between two device synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _probe_ms(probe, kind: str, reps: int, **kw) -> float:
    """ms of one unit of a probe: (reps units − none) / reps, from CUDA-graph
    replays."""
    t0 = _graph_ms(lambda: probe(kind, 0, **kw), calls=20)
    t1 = _graph_ms(lambda: probe(kind, reps, **kw), calls=20)
    return (t1 - t0) / reps


def phase_pgo_kernel(smi: str) -> dict:
    """The PGO kernel against its plain version at the circuit's in-loop spec
    on K = 2048 slots: 163 live keyframes with 9 loops (the circuit) and all
    2048 live with 40 loops; its time per launch from CUDA-graph replays in
    turns with its first version, the whole solve's and the plain solve's on
    the host's clock, the bound and the two latency floors from the source's
    probe kernels."""
    import pgo_cases
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import pose_graph as pg
    from xchu_slam_tpu_torch.ops.cuda import pgo_kernel
    from xchu_slam_tpu_torch.utils import se3

    dev = torch.device("cuda")
    spec = pg.inloop_spec(pg.spec_from_config(cli.sim_config().pgo))
    out = torch.zeros(1, device=dev)
    probe = lambda kind, reps, threads=pgo_kernel.THREADS: pgo_kernel.probe(  # noqa: E731
        kind, reps, out, threads)
    launch_ms = _graph_ms(lambda: probe("launch", 0), calls=20)
    barrier_ms = _probe_ms(probe, "barrier", 64)
    sweep_ms = _probe_ms(probe, "sweep_link", 256)
    factor_ms = _probe_ms(probe, "factor_link", 64)
    factor_col_ms = _probe_ms(probe, "factor_link_columns", 64)
    factor_lane0_ms = _probe_ms(probe, "factor_link_lane0", 64)
    link_ms_new = min(factor_col_ms, factor_lane0_ms)
    seg_link_ms = _probe_ms(probe, "segment_link", 256)
    print(f"floor [{smi}]: pgo: empty launch of 1 x {pgo_kernel.THREADS} {launch_ms:.5f} ms, "
          f"block barrier {barrier_ms:.6f} ms, substitution link {sweep_ms:.6f} ms, "
          f"factor link in one thread (the first version's) {factor_ms:.6f} ms, "
          f"this kernel's factor link with its Cholesky across six lanes "
          f"{factor_col_ms:.6f} ms, in lane 0 {factor_lane0_ms:.6f} ms, segment link "
          f"{seg_link_ms:.6f} ms")
    lib = pgo_kernel._library()
    rows = {}
    for name, n_live, n_loops in PGO_CASES:
        poses, graph = pgo_cases.chain_graph(K=2048, L=256, n_live=n_live, n_loops=n_loops,
                                             gps=True)
        p_d, g_d = torch.from_numpy(poses).to(dev), pgo_cases.to_device(graph, dev)
        got = pg.solve(p_d, g_d, spec)
        again = pg.solve(p_d, g_d, spec)
        want = pg.solve_ref(p_d, g_d, spec)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        moved = float((want - p_d).abs().max())
        if not torch.equal(got, again) or not err <= PGO_TOL or not moved > 1e-3:
            raise AssertionError(f"pgo {name}: |Δpose| {err:.3g} against the plain version "
                                 f"(> {PGO_TOL}), moved {moved:.3g}, rerun equal "
                                 f"{torch.equal(got, again)}")
        s = pg._gn_system(se3.pose_to_matrix(p_d), g_d, spec)
        args = (s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(), s.Ji.contiguous(),
                s.Jj.contiguous(), s.odom_info, s.wp, s.Jli.contiguous(), s.Jlj.contiguous(),
                g_d.loop_i, g_d.loop_j, s.wl.contiguous(), s.A.contiguous(),
                s.gz.contiguous(), g_d.kf_mask, torch.ones((), dtype=torch.bool, device=dev),
                spec.cg_tol, spec.cg_iterations)
        _x, iters = pgo_kernel.cg(*args)
        it = int(iters)
        # first version, kernel, kernel, first version
        o1, k1, k2, o2 = (_graph_ms(f, calls=10, replays=5) for f in (
            lambda: pgo_kernel._cg_first(*args), lambda: pgo_kernel.cg(*args),
            lambda: pgo_kernel.cg(*args), lambda: pgo_kernel._cg_first(*args)))
        ms, first_ms = 0.5 * (k1 + k2), 0.5 * (o1 + o2)
        plain_ms = _host_ms(lambda: pg._pcg_ref(s, g_d, spec), reps=3)
        solve_ms = _host_ms(lambda: pg.solve(p_d, g_d, spec))
        solve_ref_ms = _host_ms(lambda: pg.solve_ref(p_d, g_d, spec), reps=3)
        bytes_ms = 1e3 * (n_live * PGO_BYTES_KF + n_loops * PGO_BYTES_LOOP
                          + 2048 * 24) / HBM_BYTES_PER_S
        ops_ms = 1e3 * n_live * (PGO_FLOP_FACTOR + it * PGO_FLOP_ITER) / FP32_FLOPS
        floor_ms = (launch_ms + n_live * factor_ms + (it + 1) * 2 * n_live * sweep_ms
                    + (PGO_BARRIERS_ITER * it + PGO_BARRIERS_FIXED) * barrier_ms)
        lseg = lib.pgo_segment_links(n_live)
        nseg = -(-n_live // lseg) if lseg else 0
        depth = 2 * lseg + nseg if lseg else n_live
        link_ms = seg_link_ms if lseg else sweep_ms
        seg_floor_ms = (launch_ms + (n_live - 1) * link_ms_new
                        + 12 * lseg * seg_link_ms + (it + 1) * 2 * depth * link_ms
                        + (PGO_SEG_BARRIERS_ITER * it + PGO_SEG_BARRIERS_FIXED) * barrier_ms)
        row = {"live": n_live, "loops": n_loops, "cg_iterations": it, "max_abs_err": err,
               "ms": ms, "first_version_ms": first_ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
               "latency_floor_ms": floor_ms, "segmented_floor_ms": seg_floor_ms,
               "segment_links": lseg, "segments": nseg, "solve_ms": solve_ms,
               "solve_ref_ms": solve_ref_ms, "gn_iterations": spec.gn_iterations}
        rows[name] = row
        print(f"pgo_kernel [{smi}]: {name} ({n_live} live, {n_loops} loops, {it} CG "
              f"iterations): {ms:.5f} ms per launch on the card (graph replays {k1:.5f}/"
              f"{k2:.5f}), first version {first_ms:.5f} ms ({o1:.5f}/{o2:.5f}), "
              f"{first_ms / ms:.2f}x; bound {row['bound_ms']:.6f} ms by {row['bound_by']}; "
              f"the first version's latency floor {floor_ms:.5f} ms (launch + {n_live} "
              f"one-thread factor links + {it + 1} x 2 x {n_live} substitution links + "
              f"{PGO_BARRIERS_ITER * it + PGO_BARRIERS_FIXED} barriers: "
              f"{100 * floor_ms / ms:.1f} % of it reached); the segmented structure's floor "
              f"{seg_floor_ms:.5f} ms (launch + {n_live - 1} factor links of the faster form + "
              f"{12 * lseg} transfer links + {it + 1} x 2 x {depth} sweep links ({nseg} "
              f"segments of {lseg}) + {PGO_SEG_BARRIERS_ITER * it + PGO_SEG_BARRIERS_FIXED} "
              f"barriers: {100 * seg_floor_ms / ms:.1f} % of it reached); plain factor + CG "
              f"{plain_ms:.3f} ms (host clock, a readback a CG iteration); the in-loop solve "
              f"({spec.gn_iterations} GN) {solve_ms:.3f} ms, its plain version "
              f"{solve_ref_ms:.3f} ms; |Δpose| {err:.3g}, reruns bit-identical")
    circ = rows["circuit"]
    return {**{k: circ[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "first_version_ms")},
            "library_ms": None, "latency_floor_ms": circ["latency_floor_ms"],
            "segmented_floor_ms": circ["segmented_floor_ms"], "cases": rows,
            "floor": {"launch_ms": launch_ms, "barrier_ms": barrier_ms,
                      "substitution_link_ms": sweep_ms, "factor_link_ms": factor_ms,
                      "factor_link_columns_ms": factor_col_ms,
                      "factor_link_lane0_ms": factor_lane0_ms,
                      "segment_link_ms": seg_link_ms}}


# bytes per source point of one icp_step: the point, its mask, the NN
# kernel's index and d², the gathered target, the current point read and
# written; FP32 operations per point: the two moment passes and the transform
ICP_BYTES_PT = 12 + 1 + 4 + 4 + 12 + 12 + 12
ICP_FLOP_PT = 8 + 18 + 18
ICP_BARRIERS = 8         # the staged state, two block sums of three, the transform
ICP_EIGEN_REPS = 64


def phase_icp_kernel(smi: str) -> dict:
    """The ICP verification's CUDA graph (NN kernel + icp_step) against
    `align_ref` at the circuit's shape (4096 keyframe points, a 16,384-point
    submap); icp_step's time per launch in turns with its first version, the
    verification's, a dead trip's, the bound and the floor."""
    import icp_cases
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import icp_kernel, nn_kernel, pgo_kernel
    from xchu_slam_tpu_torch.utils import se3

    dev = torch.device("cuda")
    spec = icp.IcpSpec()
    args = icp_cases.scene(dev)
    got = icp.align(*args, spec)
    again = icp.align(*args, spec)
    want = icp.align_ref(*args, spec)
    torch.cuda.synchronize()
    err = max(float((got.T[:3, :3] - want.T[:3, :3]).abs().max()),
              float((got.T[:3, 3] - want.T[:3, 3]).abs().max()) / _lever(args[0], args[1]))
    it, it_ref = int(got.iterations), int(want.iterations)
    if not all(torch.equal(a, b) for a, b in zip(got, again)) or not err <= ICP_TOL \
            or it != it_ref or not bool(got.converged):
        raise AssertionError(f"icp: |ΔT| {err:.3g} (> {ICP_TOL}?), iterations {it} against "
                             f"{it_ref}, converged {bool(got.converged)}")
    verify_ms = _host_ms(lambda: icp.align(*args, spec), reps=10)
    verify_dev_ms = _loop_ms(lambda: icp.align(*args, spec), 20)
    plain_verify_ms = _host_ms(lambda: icp.align_ref(*args, spec), reps=5)
    # one step alone, kept live (a negative epsilon never converges), in
    # turns with the first version: first, kernel, kernel, first
    src, smask, tgt, tmask, init = args
    st = torch.zeros(icp_kernel.STATE_FLOATS, device=dev)
    cur = torch.empty_like(src)
    icp_kernel.init(src, init, torch.ones((), dtype=torch.bool, device=dev), st, cur)
    idx, d2 = nn_kernel.nearest_neighbor(cur, tgt, tmask)
    max_d2 = spec.max_corr_dist ** 2
    o1, k1, k2, o2 = (_graph_ms(lambda: f(src, smask, tgt, idx, d2, cur, st, max_d2, -1.0,
                                          1 << 30), calls=50)
                      for f in (icp_kernel._step_first, icp_kernel.step, icp_kernel.step,
                                icp_kernel._step_first))
    ms, first_ms = 0.5 * (k1 + k2), 0.5 * (o1 + o2)
    # a dead trip: the NN kernel's two launches and the step, all returning at once
    dead = torch.zeros(icp_kernel.STATE_FLOATS, device=dev)
    live = dead[icp_kernel.STATE["live"]:icp_kernel.STATE["live"] + 1]
    dead_ms = _graph_ms(lambda: (nn_kernel.nearest_neighbor(cur, tgt, tmask, live=live),
                                 icp_kernel.step(src, smask, tgt, idx, d2, cur, dead, max_d2,
                                                 spec.trans_eps, spec.max_iterations)),
                        calls=50)
    n = src.shape[0]
    bytes_ms = 1e3 * (n * ICP_BYTES_PT + 4 * icp_kernel.STATE_FLOATS) / HBM_BYTES_PER_S
    ops_ms = 1e3 * n * ICP_FLOP_PT / FP32_FLOPS
    # the floor: an empty launch of the step's geometry, its barriers and its
    # eigen-solve alone, on the cross-covariance of the first iteration
    m = icp._moments(se3.transform_points(init, src), smask, tgt, tmask, max_d2)
    M = (m[7:16] / m[0]).reshape(3, 3).contiguous()
    eig_out = torch.zeros(2, device=dev)
    eigen = lambda kind, reps: icp_kernel.probe(kind, reps, M, eig_out)  # noqa: E731
    launch_ms = _graph_ms(lambda: eigen("launch", 0), calls=20)
    eigen_ms = _probe_ms(eigen, "eigen", ICP_EIGEN_REPS)
    sweeps = int(eig_out[1])
    out = torch.zeros(1, device=dev)
    barrier_ms = _probe_ms(lambda kind, reps: pgo_kernel.probe(kind, reps, out, 512),
                           "barrier", 64)
    floor_ms = launch_ms + ICP_BARRIERS * barrier_ms + eigen_ms
    plain_ms = plain_verify_ms / (it_ref + 1)
    print(f"floor [{smi}]: icp: empty launch of 1 x 512 {launch_ms:.5f} ms, block barrier "
          f"{barrier_ms:.6f} ms, the eigen-solve alone {eigen_ms:.6f} ms ({sweeps} Jacobi "
          f"sweeps on the first iteration's cross-covariance)")
    print(f"icp_step [{smi}]: {ms:.5f} ms per launch on the card (graph replays {k1:.5f}/"
          f"{k2:.5f}, every trip live), first version {first_ms:.5f} ms ({o1:.5f}/{o2:.5f}), "
          f"{first_ms / ms:.2f}x; a dead trip (NN kernel's two launches + the step, all "
          f"returning at once) {dead_ms:.5f} ms; bound {max(bytes_ms, ops_ms):.6f} ms by "
          f"{'bytes' if bytes_ms > ops_ms else 'operations'}, floor {floor_ms:.5f} ms (launch "
          f"{launch_ms:.5f} + {ICP_BARRIERS} barriers of {barrier_ms:.6f} + eigen-solve "
          f"{eigen_ms:.6f}: {100 * floor_ms / ms:.1f} % of it reached); a verification ({it} "
          f"iterations of {spec.max_iterations} trips, the graph replay) {verify_ms:.3f} ms on "
          f"the host's clock, {verify_dev_ms:.3f} ms per verification over 20 enqueued; plain "
          f"version {plain_verify_ms:.3f} ms ({plain_ms:.4f} ms an iteration, a readback "
          f"each); |ΔT| {err:.3g}, the same iteration count, reruns bit-identical")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations", "library_ms": None,
            "first_version_ms": first_ms, "latency_floor_ms": floor_ms,
            "eigen_ms": eigen_ms, "jacobi_sweeps": sweeps, "dead_trip_ms": dead_ms,
            "verification_ms": verify_ms, "verification_device_ms": verify_dev_ms,
            "plain_verification_ms": plain_verify_ms, "iterations": it}


def _count_launches(fn):
    """(fn's result, {"nn", "ndt", "pgo", "icp_step", "icp_live_trips"}: the
    launches of each kernel it made, and the ICP iterations that were live):
    the counts are set to 0 just before and read just after."""
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import icp_kernel, ndt_kernel, nn_kernel, pgo_kernel

    ndt_kernel.launches = nn_kernel.launches = pgo_kernel.launches = icp_kernel.launches = 0
    trips = icp.live_trip_count()
    out = fn()
    return out, {"nn": nn_kernel.launches, "ndt": ndt_kernel.launches,
                 "pgo": pgo_kernel.launches, "icp_step": icp_kernel.launches,
                 "icp_live_trips": icp.live_trip_count() - trips}


def _check_loop_kernels(name: str, counts: dict, verifications: int, loops: int,
                        solve_gn: int) -> None:
    """Every path with a verification launched icp_step, every accepted loop
    the PGO kernel (the in-loop solve's Gauss-Newton iterations)."""
    if verifications and counts["icp_step"] < 1:
        raise AssertionError(f"{name}: {verifications} verifications launched no icp_step")
    if verifications and counts["icp_live_trips"] < 1:
        raise AssertionError(f"{name}: icp_step ran no live trip")
    if counts["pgo"] < loops * solve_gn:
        raise AssertionError(f"{name}: {loops} accepted loops, {counts['pgo']} PGO launches")


def _inloop_gn(pipe) -> int:
    from xchu_slam_tpu_torch.models import pose_graph as pg

    return pg.inloop_spec(pipe.gspec).gn_iterations


ICP_SAME_ITERS = 0.95     # share of the circuit's verifications with the plain version's count


def _replay_verifications(calls) -> dict:
    """Each recorded verification of a run again through `align_ref`: the
    share with the same iteration count and the largest |ΔT| among them."""
    from xchu_slam_tpu_torch.ops import icp

    same, err_r, err_t = 0, 0.0, 0.0
    for args, res in calls:
        want = icp.align_ref(*args)
        if int(want.iterations) == int(res.iterations):
            same += 1
            err_r = max(err_r, float((want.T[:3, :3] - res.T[:3, :3]).abs().max()))
            err_t = max(err_t, float((want.T[:3, 3] - res.T[:3, 3]).abs().max())
                        / _lever(args[0], args[1]))
    out = {"verifications": len(calls), "same_iterations": same, "max_abs_err_R": err_r,
           "max_err_t_over_lever": err_t}
    if same < ICP_SAME_ITERS * len(calls) or not err_r <= ICP_TOL or not err_t <= ICP_TOL:
        raise AssertionError(f"icp on the circuit against align_ref: {out}")
    return out


def phase_main() -> tuple[dict, dict]:
    from xchu_slam_tpu_torch.cli import run_sim
    from xchu_slam_tpu_torch.ops import icp

    calls, align = [], icp.align

    def recording_align(*args, **kw):
        res = align(*args, **kw)
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                      res))
        return res

    icp.align = recording_align
    try:
        (pipe, summary), counts = _count_launches(
            lambda: run_sim(SCANS, RADIUS, SEED, "cuda"))
    finally:
        icp.align = align
    replay = _replay_verifications(calls)
    print("main: the circuit's verifications again through align_ref " + json.dumps(replay))
    launches = counts["nn"]
    odo = pipe.odometry_trajectory()
    _, _, kf_opt = pipe.keyframe_trajectory()
    _check_loop_kernels("main", counts, pipe.icp_verifications, summary["loops"],
                        _inloop_gn(pipe))
    summary.update(icp_verifications=pipe.icp_verifications, nn_launches=launches,
                   ndt_launches=counts["ndt"], pgo_launches=counts["pgo"],
                   icp_step_launches=counts["icp_step"],
                   icp_live_trips=counts["icp_live_trips"],
                   mean_newton_iterations=round(float(np.mean(
                       [r["iterations"] for r in pipe.odom_log])), 3))
    print("main: " + json.dumps(summary))
    if odo.shape != (SCANS - 1, 6) or not np.isfinite(odo).all() \
            or not np.isfinite(kf_opt).all():
        raise AssertionError("trajectory has the wrong shape or non-finite poses")
    if launches < 1:
        raise AssertionError("the main path launched no NN kernel")
    if counts["ndt"] < SCANS - 1:
        raise AssertionError(f"the main path launched the NDT kernel {counts['ndt']} "
                             f"times over {SCANS} scans")
    if summary["loops"] < 1:
        raise AssertionError("the circuit closed no loop")
    if not summary["ate_rmse_m"] < 1.0:
        raise AssertionError(f"aligned ATE {summary['ate_rmse_m']} m ≥ 1.0 m")
    return counts, summary


def phase_session() -> dict:
    """Launches of both kernels in the session run, in `localize` and in the
    resume."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io import export, kitti
    from xchu_slam_tpu_torch.utils import checkpoint, sim
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    last_ckpt = (SCANS - 1) // CHECKPOINT_EVERY * CHECKPOINT_EVERY
    keep = range(last_ckpt + 1, last_ckpt + 1 + RESUME_SCANS)
    kept = {}

    def on_scan(i, res, scan):
        if i in keep:
            kept[i] = (scan, res["pose"])

    with tempfile.TemporaryDirectory(prefix="xchu_session_") as tmp:
        timers = StageTimers("cuda")
        (pipe, summary), counts = _count_launches(lambda: cli.run_sim(
            SCANS, RADIUS, SEED, "cuda", on_scan=on_scan, loop_method="isc",
            imu=True, wheel=True, gps=True, out=tmp,
            checkpoint_every=CHECKPOINT_EVERY, timers=timers))
        paths = summary.pop("artifacts")
        launches = counts["nn"]
        _check_loop_kernels("session", counts, pipe.icp_verifications, summary["loops"],
                            _inloop_gn(pipe))
        summary.update(icp_verifications=pipe.icp_verifications, nn_launches=launches,
                       ndt_launches=counts["ndt"], pgo_launches=counts["pgo"],
                       icp_step_launches=counts["icp_step"],
                       icp_live_trips=counts["icp_live_trips"],
                       mean_newton_iterations=round(float(np.mean(
                           [r["iterations"] for r in pipe.odom_log])), 3),
                       gps_factors=int(pipe.graph.gps_mask.sum()),
                       artifacts=sorted(paths))
        print("session: " + json.dumps(summary))
        print(timers.report(), file=sys.stderr)
        _, _, kf_opt = pipe.keyframe_trajectory()
        if not (np.isfinite(pipe.odometry_trajectory()).all() and np.isfinite(kf_opt).all()):
            raise AssertionError("session: non-finite poses")
        if launches < 1 or counts["ndt"] < SCANS - 1:
            raise AssertionError(f"the session launched the NN kernel {launches} and "
                                 f"the NDT kernel {counts['ndt']} times")
        if summary["loops"] < 1:
            raise AssertionError("the session closed no ISC loop")
        if not summary["ate_rmse_m"] < 1.0:
            raise AssertionError(f"session: aligned ATE {summary['ate_rmse_m']} m ≥ 1.0 m")

        # every artifact reads back
        missing = [k for k, v in paths.items() if not os.path.getsize(v) > 0]
        if missing or not {"odom_tum", "lidar_odom", "trajectory_pcd", "final_map_pcd",
                           "g2o", "markers", "odom_log"} <= set(paths):
            raise AssertionError(f"artifacts missing or empty: {missing or sorted(paths)}")
        stamps, est = kitti.read_tum(paths["odom_tum"])
        map_pts = export.read_pcd(paths["final_map_pcd"])
        with open(paths["g2o"]) as f:
            edges = sum(line.startswith("EDGE_SE3:QUAT") for line in f)
        with open(paths["markers"]) as f:
            markers = json.load(f)
        with open(paths["odom_log"]) as f:
            log_rows = sum(1 for _ in f)
        print(f"artifacts: odom_tum {len(stamps)} rows, finalMap.pcd {len(map_pts)} "
              f"points, g2o {edges} edges, markers {len(markers['nodes'])} nodes / "
              f"{len(markers['loop_edges'])} loop edges, odom_log {log_rows} rows")
        if len(stamps) != summary["keyframes"] or not np.isfinite(est).all():
            raise AssertionError("odom_tum.txt does not hold the keyframes")
        if len(map_pts) == 0 or not np.isfinite(map_pts).all():
            raise AssertionError("finalMap.pcd is empty or non-finite")
        if edges != summary["keyframes"] - 1 + summary["loops"] \
                or len(markers["loop_edges"]) != summary["loops"] \
                or log_rows != SCANS - 1:
            raise AssertionError("pose_graph.g2o / markers.json / odom_log.jsonl "
                                 "do not hold the run's graph")

        # eval of the exported trajectory against the ground truth as a TUM file
        _stamps, gt, _world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
        cam_T = sim.camera_frame_transform()
        gt_path = os.path.join(tmp, "gt_tum.txt")
        kitti.write_tum(gt_path, 0.1 * np.arange(SCANS),
                        cam_T @ cli._gt_in_map_frame(gt) @ np.linalg.inv(cam_T))
        ev = cli.evaluate(paths["odom_tum"], gt_path)
        print("eval: " + json.dumps(ev))
        if ev["pairs"] != summary["keyframes"] \
                or abs(ev["ape_rmse_m"] - summary["ate_rmse_m"]) > 1e-3:
            raise AssertionError("eval of odom_tum.txt disagrees with the run's ATE")

        # localize fresh scans against the checkpoint, read from disk
        ckpt = os.path.join(tmp, "checkpoint.npz")
        t0 = time.perf_counter()
        loc, loc_counts = _count_launches(lambda: cli.localize_sim(
            ckpt, QUERIES, SCANS, RADIUS, SEED, fitness_thresh=FITNESS_THRESH,
            device="cuda"))
        loc_s = time.perf_counter() - t0
        rows = loc.pop("results")
        loc_launches = loc_counts["nn"]
        loc.update(session="checkpoint.npz", nn_launches=loc_launches,
                   ndt_launches=loc_counts["ndt"], icp_step_launches=loc_counts["icp_step"],
                   icp_live_trips=loc_counts["icp_live_trips"],
                   seconds=round(loc_s, 2), fitness_thresh=FITNESS_THRESH,
                   pos_err_m=[r.get("pos_err_m") for r in rows])
        print("localize: " + json.dumps(loc))
        if loc["localized"] < 1 or loc_launches < 1 or loc_counts["icp_step"] < 1:
            raise AssertionError("localize placed no query")
        if not loc["median_err_m"] < 1.5:
            raise AssertionError(f"localize: median error {loc['median_err_m']} m ≥ 1.5 m")

        # the checkpoint resumes to the poses the uninterrupted run logged
        def resume():
            again = checkpoint.load_checkpoint(ckpt)
            if again.scan_count != last_ckpt + 1 or again.device.type != "cuda":
                raise AssertionError("the checkpoint is not the one of scan "
                                     f"{last_ckpt} on the card")
            return [again.process_scan(**kept[i][0])["pose"] for i in keep]

        poses, resume_counts = _count_launches(resume)
        want = np.stack([kept[i][1] for i in keep])
        if not np.array_equal(np.stack(poses), want):
            raise AssertionError("the resumed run's poses differ from the "
                                 f"uninterrupted run's by {np.abs(np.stack(poses) - want).max()}")
        if resume_counts["ndt"] < RESUME_SCANS - 1:
            raise AssertionError(f"the resume launched the NDT kernel "
                                 f"{resume_counts['ndt']} times over {RESUME_SCANS} scans")
        print(f"resume: checkpoint of scan {last_ckpt} loaded, scans "
              f"{keep[0]}-{keep[-1]} bit-identical to the uninterrupted run; launches "
              + json.dumps(resume_counts))
    return {"session": counts, "localize": loc_counts, "resume": resume_counts}


DEV_CHUNK = 16
DEV_RERUN_SCANS = 64
DEV_PROFILE_CHUNKS = 4
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
               "cuLaunchKernelEx")
SYNC_APIS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _staged_chunks(n_chunks: int, cfg):
    """The circuit's first chunks, rendered and staged in this thread (no
    staging thread runs beside what is measured or checked)."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io.prefetch import ChunkStager
    from xchu_slam_tpu_torch.utils import sim

    gt_stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    lazy = sim.RenderedScans(world, gt, seed=SEED, n_points=24_000)
    stager = ChunkStager(cfg.filter.max_raw_points, DEV_CHUNK, n_buffers=n_chunks,
                         device="cuda")
    out = []
    for c in range(n_chunks):
        lo = c * DEV_CHUNK
        hi = min(lo + DEV_CHUNK, SCANS)
        clouds, n_real = stager.stage([lazy[i] for i in range(lo, hi)])
        stamps = np.zeros(DEV_CHUNK, np.float32)
        stamps[:hi - lo] = gt_stamps[lo:hi]
        out.append((clouds, stamps, n_real))
    torch.cuda.synchronize()
    return out


def _profile_window(fn, scans: int) -> dict:
    """Launch and synchronisation calls the host made, kernels the card ran
    and the card's busy share while `fn()` ran and the card drained
    (torch.profiler; the window ends in a device synchronise of its own, which
    is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = syncs = kernels = 0
    device_us = 0.0
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += e.self_device_time_total
            kernels += e.count
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + e.self_device_time_total
        elif e.key in LAUNCH_APIS:
            launches += e.count
        elif e.key in SYNC_APIS:
            syncs += e.count
    return {"scans": scans, "wall_s": round(wall, 4),
            "host_launch_calls_per_scan": round(launches / scans, 2),
            "host_sync_calls_per_scan": round((syncs - 1) / scans, 3),
            "device_kernels_per_scan": round(kernels / scans, 1),
            "device_ms_per_scan": round(1e-3 * device_us / scans, 4),
            "device_busy_share": round(1e-6 * device_us / wall, 4),
            "top_kernels_ms_per_scan": {
                k[:90]: round(1e-3 * v / scans, 4)
                for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]}}


def phase_device_engine(host_summary: dict) -> dict:
    """The device engine through the CLI's functions at full width, and what
    its Part A costs. Returns the launches of both kernels by path."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline

    # the whole circuit, Part B included, under sync debug mode "error" (the
    # chunks staged in this thread: the mode is global): the first chunk
    # (seed, one eager scan, the capture, replays), then replays only; chunks
    # 2-5 also under the profiler
    cfg = cli.sim_config()
    n_chunks = -(-SCANS // DEV_CHUNK)
    chunks = _staged_chunks(n_chunks, cfg)
    pipe = DeviceSlamPipeline(cfg, log_capacity=8192, device="cuda", check_sync=True)

    def feed(part):
        for clouds, stamps, n_real in part:
            pipe.process_chunk(clouds, stamps, n_real)

    def checked():
        feed(chunks[:2])
        torch.cuda.synchronize()
        if pipe.part_a_replays != 2 * DEV_CHUNK - 2 or pipe.chunk_readbacks != 2:
            raise AssertionError(f"Part A: {pipe.part_a_replays} graph replays and "
                                 f"{pipe.chunk_readbacks} readbacks over 2 chunks")
        warm = _profile_window(lambda: feed(chunks[2:2 + DEV_PROFILE_CHUNKS]),
                               DEV_PROFILE_CHUNKS * DEV_CHUNK)
        feed(chunks[2 + DEV_PROFILE_CHUNKS:])
        pipe.finalize()
        return warm

    prof, counts = _count_launches(checked)
    if pipe.chunk_readbacks != n_chunks or pipe.scan_count != SCANS:
        raise AssertionError(f"device: {pipe.chunk_readbacks} readbacks over {n_chunks} "
                             f"chunks, {pipe.scan_count} scans")
    _check_loop_kernels("device (checked)", counts, pipe.icp_verifications,
                        pipe.loop_count, _inloop_gn(pipe))
    if pipe.loop_count < 1 or pipe.icp_verifications < 1:
        raise AssertionError("device: the checked circuit verified or closed no loop")
    print(f"device: the circuit's {n_chunks} chunks, Part B included, under "
          f"set_sync_debug_mode('error') without raising: {pipe.chunk_readbacks} "
          f"readbacks (one a chunk), {pipe.part_a_replays} CUDA-graph replays, "
          f"{pipe.kf_count} keyframes, {pipe.icp_verifications} verifications, "
          f"{pipe.loop_count} loops; launches " + json.dumps(counts))
    stage = {k: round(v, 4) for k, v in pipe.stage_seconds.items()}
    print("device: stage seconds of the checked circuit " + json.dumps(stage))
    # Part A alone, 16 replays, on the finished engine
    clouds, stamps, _n = chunks[-1]
    one = type(clouds)(*(t[0] for t in clouds))
    stamp = torch.zeros((), device="cuda")
    prof_a = _profile_window(
        lambda: [pipe._run_part_a(one, stamp) for _ in range(DEV_CHUNK)], DEV_CHUNK)
    print("device: 4 warm chunks (Part A + readback + Part B) " + json.dumps(prof))
    print("device: Part A alone, 16 replays " + json.dumps(prof_a))
    del pipe, chunks
    torch.cuda.empty_cache()

    # the circuit through run-sim --engine device, with its export
    with tempfile.TemporaryDirectory(prefix="xchu_device_") as tmp:
        (pipe, summary), counts = _count_launches(lambda: cli.run_sim(
            SCANS, RADIUS, SEED, "cuda", engine="device", chunk=DEV_CHUNK, out=tmp))
        dev_counts = counts
        ndt_n, nn_n = counts["ndt"], counts["nn"]
        paths = summary.pop("artifacts")
        _check_loop_kernels("device", counts, pipe.icp_verifications, summary["loops"],
                            _inloop_gn(pipe))
        if pipe.chunk_readbacks != summary["chunk_attribution"]["chunks"]:
            raise AssertionError(f"device: {pipe.chunk_readbacks} readbacks over "
                                 f"{summary['chunk_attribution']['chunks']} chunks")
        summary.update(icp_verifications=pipe.icp_verifications, ndt_launches=ndt_n,
                       nn_launches=nn_n, pgo_launches=counts["pgo"],
                       icp_step_launches=counts["icp_step"],
                       icp_live_trips=counts["icp_live_trips"],
                       part_a_replays=pipe.part_a_replays,
                       chunk_readbacks=pipe.chunk_readbacks,
                       stage_seconds_device={k: round(v, 4)
                                             for k, v in pipe.stage_seconds.items()},
                       host_engine_scans_per_sec=host_summary["scans_per_sec"],
                       mean_newton_iterations=round(float(np.mean(
                           [r["iterations"] for r in pipe.odom_log[1:]])), 3))
        print("device: " + json.dumps(summary))
        odo = pipe.odometry_trajectory()
        _, _, kf_opt = pipe.keyframe_trajectory()
        if odo.shape != (SCANS, 6) or not np.isfinite(odo).all() \
                or not np.isfinite(kf_opt).all():
            raise AssertionError("device: trajectory has the wrong shape or "
                                 "non-finite poses")
        if ndt_n < SCANS - 1 or nn_n < 1:
            raise AssertionError(f"device: {ndt_n} NDT and {nn_n} NN launches")
        if abs(summary["keyframes"] - host_summary["keyframes"]) > 2:
            raise AssertionError(f"device: {summary['keyframes']} keyframes against "
                                 f"the host engine's {host_summary['keyframes']}")
        if summary["loops"] < 1:
            raise AssertionError("device: the circuit closed no loop")
        if not summary["ate_rmse_m"] < 0.10:
            raise AssertionError(f"device: aligned ATE {summary['ate_rmse_m']} m ≥ 0.10 m")
        stamps, est = kitti.read_tum(paths["odom_tum"])
        with open(paths["odom_log"]) as f:
            log_rows = sum(1 for _ in f)
        if len(stamps) != summary["keyframes"] or not np.isfinite(est).all() \
                or log_rows != SCANS:
            raise AssertionError("device: --out does not hold the run")
        print(f"device: --out read back: odom_tum {len(stamps)} rows, odom_log "
              f"{log_rows} rows, {len(paths)} files")
    del pipe
    torch.cuda.empty_cache()

    # a short run with the radius retrieval and GPS factors
    (pipe, short), counts = _count_launches(lambda: cli.run_sim(
        DEV_RERUN_SCANS, RADIUS, SEED, "cuda", engine="device", chunk=DEV_CHUNK,
        loop_method="radius", gps=True))
    ndt_r, nn_r = counts["ndt"], counts["nn"]
    radius_counts = counts
    _check_loop_kernels("device radius + gps", counts, pipe.icp_verifications,
                        short["loops"], _inloop_gn(pipe))
    short.update(gps_factors=int(pipe.graph.gps_mask.sum()), ndt_launches=ndt_r,
                 pgo_launches=counts["pgo"], icp_step_launches=counts["icp_step"])
    print("device: radius + gps " + json.dumps(short))
    if short["keyframes"] < 2 or short["gps_factors"] < 1 or ndt_r < DEV_RERUN_SCANS - 1 \
            or not np.isfinite(pipe.keyframe_trajectory()[2]).all():
        raise AssertionError("device: the radius + gps run is not right")
    del pipe
    torch.cuda.empty_cache()

    # a rerun from a fresh state is bit-identical
    runs = []
    for _ in range(2):
        pipe, _s = cli.run_sim(DEV_RERUN_SCANS, RADIUS, SEED, "cuda", engine="device",
                               chunk=DEV_CHUNK)
        runs.append(pipe.odometry_trajectory())
        del pipe
        torch.cuda.empty_cache()
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("device: reruns differ (max |Δpose| "
                             f"{np.abs(runs[0] - runs[1]).max()})")
    print(f"device: {DEV_RERUN_SCANS} scans twice, poses bit-identical")
    return {"paths": {"device": dev_counts, "device_radius_gps": radius_counts},
            "profile": prof, "profile_part_a": prof_a, "summary": summary}


def phase_determinism() -> None:
    from xchu_slam_tpu_torch.cli import run_sim

    runs = []
    for _ in range(2):
        poses = []
        run_sim(DET_SCANS, RADIUS, SEED, "cuda",
                on_scan=lambda i, r, scan: poses.append(r["pose"]))
        runs.append(np.stack(poses))
    if not np.array_equal(runs[0], runs[1]):
        diff = np.abs(runs[0] - runs[1]).max()
        raise AssertionError(f"reruns differ (max |Δpose| {diff})")
    print(f"determinism: {DET_SCANS} scans twice, poses bit-identical")


def main() -> int:
    sys.path[:0] = [_HERE, os.path.join(_HERE, "tests")]
    t0 = time.perf_counter()
    smi = phase_device()
    ptxas = phase_build()
    only_device = "--device-only" in sys.argv[1:]
    rec = None if only_device else phase_kernel()
    if "--kernel-only" in sys.argv[1:]:
        return 0
    ndt_rec = None if only_device else phase_ndt_kernel(smi)
    pgo_rec = None if only_device else phase_pgo_kernel(smi)
    icp_rec = None if only_device else phase_icp_kernel(smi)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    launches, host_summary = phase_main()
    if "--device-only" in sys.argv[1:]:
        phase_device_engine(host_summary)
        return 0
    by_path = {"main": launches, **phase_session()}
    phase_determinism()
    dev = phase_device_engine(host_summary)
    by_path.update(dev["paths"])

    def per_path(key):
        return {k: v[key] for k, v in by_path.items()}

    kernels = [{"name": "nn_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/nn_kernel.cu",
                "replaces": "xchu_slam_tpu/ops/pallas/nn_kernel.py:29",
                "launches": launches["nn"], "launches_by_path": per_path("nn"), **rec,
                "ptxas": {k: v for k, v in ptxas.items() if k in ("first version", "merge",
                                                                    "scan")}},
               {"name": "ndt_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/ndt_kernel.cu",
                "replaces": "none: xchu_slam_tpu/ops/ndt.py:477 and :539 (two "
                            "lax.while_loop that the reference leaves to XLA)",
                "launches": launches["ndt"], "launches_by_path": per_path("ndt"),
                **ndt_rec, "ptxas": {"ndt align": ptxas["ndt align"]}},
               {"name": "pgo_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/pgo_kernel.cu",
                "replaces": "none: xchu_slam_tpu/models/pose_graph.py:221, :251, :257 and "
                            ":459 (lax.scan, two associative_scan, lax.while_loop that the "
                            "reference leaves to XLA)",
                "launches": launches["pgo"], "launches_by_path": per_path("pgo"),
                **pgo_rec, "ptxas": {k: ptxas[k] for k in ("pgo", "pgo first version")}},
               {"name": "icp_step", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/icp_kernel.cu",
                "replaces": "none: xchu_slam_tpu/ops/icp.py:114-173 (the body of a "
                            "lax.while_loop that the reference leaves to XLA)",
                "launches": launches["icp_step"], "launches_by_path": per_path("icp_step"),
                "live_trips_by_path": per_path("icp_live_trips"), **icp_rec,
                "ptxas": {k: ptxas[k] for k in ("icp step", "icp step first version", "icp init",
                                                 "icp fitness")}}]
    print(f"total: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
