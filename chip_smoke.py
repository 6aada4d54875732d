#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`xchu_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; fails if there is no CUDA device or TF32 is on
  2. build    nvcc-compiles the five kernel sources (csrc/nn_kernel.cu,
              ndt_kernel.cu, pgo_kernel.cu, icp_kernel.cu, guess_kernel.cu,
              sm_90a) and the
              PGO and ICP kernels' first versions (pgo_kernel_first.cu,
              icp_kernel_first.cu), one nvcc each, and the scan loader
              (native/loader.cpp, g++, into build/native/), started together;
              prints ptxas's registers, shared memory and spills (none allowed
              but in the NDT kernel's instantiations of SPILL_EXEMPT)
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
  5b. mesh   the sharded ops (`xchu_slam_tpu_torch/parallel`, the `mesh=`
              branches): first the new entry points against their plain
              versions at the shards' shapes (D = 2 and 4) of the circuit's
              first align and verification: the NDT kernel's shard pass in
              its three kinds at two pose pairs (within 1e-5), icp_partial
              and icp_solve (within ICP_TOL), icp_partial + icp_solve
              against icp_step bit for bit over a whole verification; their
              times from CUDA-graph replays beside their bounds and plain
              versions, and the NN kernel's at the shard's shapes. Then
              rank groups through `parallel/distributed.launch`, fresh
              interpreters (gloo at D = 2 and 4 sharing card 0, each
              collective staged through pinned host memory; NCCL at D = 1;
              NCCL at D = min(4, cards) where the machine has several
              cards), each replaying what phase 5 recorded: its first 64
              aligns, every Scan Context retrieval (the count printed), its
              verifications, its final graph (163 live of 2048) and phase
              4b's 2048-live graph, and slam_superstep on the first 8 scans. The ranks agree bit
              for bit; NDT holds phase 4's rule against the kernel's aligns,
              SC the same candidates, ICP the same iterations and |ΔT| ≤
              ICP_TOL (bit for bit at one rank), PGO |Δpose| ≤ 1e-4,
              slam_superstep its components; every kernel of the path
              launched on every group. Prints ms an op (CUDA events), the
              launches a rank of each kernel and the collectives and
              host-staged collectives of each op
  5c. mesh_engine  the mesh device engine (`DeviceSlamPipeline(mesh=)`)
              through the CLI's functions at run-sim's width, each run a
              group of ranks (`cli.run_on_mesh`: fresh interpreters, gloo
              with the ranks on card 0 where the machine has fewer cards
              than ranks), held to phase 8's single-device run of the
              circuit (the whole run makes 5c after phase 8 and gives it
              that run; --mesh-only makes it first): (a) `run-sim --engine
              device --chunk 16 --mesh 2 --checkpoint-every 200 --out <tmp>`
              on the circuit
              (ranks agree, keyframes within ±2 of phase 8's, loops ≥ 1,
              aligned ATE < 1.0 m, the export read back), then its
              checkpoint resumed on the mesh for 2 chunks (rows bit-identical
              on both ranks); (b) NCCL D = 1 through `DeviceSlamPipeline(mesh=)`
              on the first 32 scans (rows within 1e-4 of phase 8's); (c)
              `--loop-method isc --imu --wheel --gps` at D = 2 (loops ≥ 1, a
              guess launch a scan on every rank); (d) `--continue-session` of
              (a)'s checkpoint at D = 2 over 64 scans (relocalized within 2
              m, ≥ 20 new keyframes); (e) the first 16 scans at D = 4
              (keyframes within ±2 of phase 8's); (f) `run-kitti --engine
              device --mesh 2` on 32 HDL-64-density files (native reader,
              ATE < 1.0 m); (g) `run-sim --mesh 2 --render-procs 3` on the
              circuit's first 64 scans, each rank forking its workers before
              it forms its group (rows bit-identical to (a)'s first 64, or to
              a 64-scan run without workers where the runs are not
              prefix-stable; no scan rendered inline on either rank; the
              mean wait a chunk beside (a)'s). Every rank of every run launches the NDT
              kernel's shard pass on every align and never the align
              kernel, the PGO kernel, and where it verified a loop the NN
              kernel, icp_partial and icp_solve with ≥ 1 live ICP trip.
              Prints each run's launches and live ICP trips a rank, host
              synchronisations (sync debug mode "warn"),
              collectives and host-staged collectives a scan, scans/s and
              stage seconds beside phase 8's
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
  4d. guess_kernel  the external-guess kernel against its plain chain
              (`imu.ext_guess_ref`) over the circuit's first 64 IMU + wheel
              windows from the odometry's own poses (|Δ| ≤ 1e-5, reruns
              bit-identical, the NDT iteration count from either guess the
              same on ≥ 9 in 10); µs per launch from CUDA-graph replays, the
              plain chain's time and kernel count inside a graph, the bound,
              the floor (an empty 1 × 32 launch + the dependent chain, from
              the source's probe kernel); ptxas's figures in phase 2
After phase 8:
  9. device_session  the device engine as a whole session: the circuit's
              chunks with IMU + wheel windows under
              `set_sync_debug_mode("error")` (one readback a chunk, a guess
              launch a scan) and Part A with windows under the profiler;
              `run-sim --engine device --loop-method isc --imu --wheel --gps
              --checkpoint-every 200 --out <tmp>` (NDT and guess launches ≥
              one a scan after the first, loops ≥ 1, aligned ATE < 1.0 m, its
              mean Newton iterations beside phase 8's constant-velocity run);
              the export read back, `eval` within 1e-3 of the run's ATE;
              `localize --queries 12 --fitness-thresh 1.5` against the device
              checkpoint (≥ 1 found, median error < 1.5 m); the checkpoint
              resumed for 2 chunks, rows bit-identical to the uninterrupted
              run's; `run-sim --continue-session` of it (relocalized within
              2 m, ≥ 20 new keyframes, loops above the saved count, ATE of
              the continued keyframes < 1.0 m); `batch_step` at B = 1, 4, 8
              over 32 scans a member (each member bit-equal to its single
              run, ms a step)
After phase 9:
 10. modes   the modes other than the default, each an instantiation of its
              kernel: (a) each NDT mode (backtrack + direct1 / direct26 /
              kdtree, mt_exact and ref_clamped + direct7) against `align_ref`
              in that mode on the circuit's first 64 aligns at full width
              (the same iteration and trial counts on ≥ 60, |Δpose| ≤ 2e-5
              on those, or no more than the plain version's own spread
              from the CPU to the card on that align, reruns
              bit-identical), ms an align from CUDA-graph
              replays, the bound by bytes (rows gathered × M), the latency
              floor, ptxas's figures; (a') `ndt.regather_dist=0.3` (a launch
              argument of the default instantiation) against `align_ref` with
              it on the same 64 aligns (the same Newton count on ≥ 62,
              |Δpose| ≤ 1e-5 on those), Newton iterations a scan and the last
              align's ms beside the default's on the same inputs, and
              direct7_rows bit-equal to direct7 on each; (b) the jacobi PGO kernel against
              `solve_ref` with jacobi at 163 and 2048 live (|Δpose| ≤ 1e-4),
              CG trips, ms a launch; (c) `run-sim --engine device --chunk 16`
              on the circuit with each `--set` of MODE_SETTINGS, then again
              (an NDT mode's first 64 scans, jacobi's whole circuit):
              keyframes, loops, aligned ATE, Newton iterations and trials a
              scan, scans/s, NDT and PGO launches (≥ 1 loop, ATE < 1.0 m, the
              rerun bit-identical)
After phase 10:
 11. sources  every scan source of the reference, each run in a fresh
              interpreter (`--sources-child`) so that its render workers
              fork before its first CUDA call: `run-sim --engine device` on
              the circuit without and with `--render-procs 3` (pose hashes
              identical, no scan rendered inline; `mean_wait_ms`,
              `mean_dispatch_ms` and the streaming rate both ways); the
              reference's "realism" configuration (`--realism --render-procs
              5 --prefetch-threads 3 --prefetch-depth 6`, ≥ 1 loop, ATE <
              1.0 m) and `--realism` through the host engine on 120 scans; a
              TUM file of a closed lap of `closed_lap_trajectory` and 80 more
              scans (camera frame) through `--trajectory --engine device
              --render-procs 3 --imu --wheel` with a checkpoint (≥ 1 loop, a
              guess launch a scan), then `localize --trajectory` against it
              (≥ 1 found, median error < 1.5 m); the reference's "fast"
              configuration (`--set filter.outlier_method=statistical_approx
              --render-procs 5 --prefetch-threads 3 --prefetch-depth 6`: pose
              hash equal to the run with 3 workers', its warm rate beside
              it); `run-kitti` at the default
              config on 380 `.bin` scans of a closed circuit at HDL-64 density
              (~120,000 points) written to a temporary directory: the host
              engine with and without `defer_sync` (poses identical, scans/s
              both ways) and the device engine, with the radius filter and
              with `filter.outlier_method=statistical_bucketed` (buckets of 6
              voxels, BUCKETED), each closing ≥ 1 loop with the native
              reader; then on 32 of the files the bucketed filter, with
              buckets of 4 (the default) and 6 voxels, against the exact one
              on the card (proven, fallback-fixed and unknown rows, ms a scan
              of each, the kept flags held to the bucketed rule but for the
              points within 1e-5 of the threshold, which are counted)
After phase 11:
 12. extras  the modules the reference runs beside its main path, at
              run-sim's full width on the circuit: (a) `--set
              filter.detect_ground=true` through the host engine (a valid
              plane on most scans, median |d - 1.73| < 0.05 m, ground ms a
              scan from CUDA events, scans/s beside phase 5's, poses and NN /
              NDT launches equal to phase 5's; on 16 scans `detect_plane` on
              the card, enqueued with no host synchronisation, against the CPU
              given the card's triples); (b) `--set
              loop.async_detect=true`: free-running (≥ 1 loop, ATE < 1.0 m,
              scans/s beside phase 5's), then with each job waited for (a hash
              of every pose equal to phase 5's); (c) GICP between 16 pairs of
              consecutive keyframe clouds on the card against the CPU (the
              same iteration count on ≥ 9 in 10, |Δpose| ≤ 1e-4 on those, ms an
              align); (d) the window and distance localmaps over the last 20
              and 50 keyframes on the card against the CPU (point counts and
              validity equal, voxel means within 1e-4 m, inverse covariances
              of both within 2e-4 / eig_inflation of a float64 finalize of
              their sums, ms a build); (e) inside the waiting run, `device_trace`
              over the 4 scans around the first verification: the trace names
              the NDT and NN kernels (its size printed)
Phases 5-12 also assert that every path with a verification launched
icp_step and every accepted loop the PGO kernel; phases 8 and 9 run the whole
circuit, Part B included, under `set_sync_debug_mode("error")` with one
readback a chunk, and check `chunk_readbacks` of `run-sim --engine device`.
Then one JSON line of kernel records (all five kernels and the mesh's three
entry points, with the launches of each path, 5c's runs among them (rank
0's); the NDT and PGO entries with their modes' records, the NN kernel's
with its time at the shards' shapes) and, last, the
result line. `--kernel-only` stops after phase 3, `--kernels-only` after
phase 4d, `--modes-only` runs phases 1-4d and 10, `--device-only` runs
phases 1, 2, 5, 8 and 9, `--sources-only` runs phases 1, 2 and 11,
`--extras-only` runs phases 1, 2, 5 and 12, `--mesh-only` phases 1, 2, 5,
5b and 5c; none of the seven prints a result line.
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
# the NDT kernel's instantiations (voxels a point, line search) and their names
NDT_LS = ("backtrack", "mt_exact", "ref_clamped")
NDT_INSTANCES = {(m, ls): "ndt align" if (m, ls) == (7, 0) else f"ndt align {m} {NDT_LS[ls]}"
                 for m in (1, 7, 27) for ls in range(3)}
# mangled-name fragments of the kernels, and what they are
PTXAS_NAMES = (("nn_kernel_simple", "first version"),
               ("nn_merge_kernel", "merge"),
               ("nn_kernel", "scan"),
               *((f"ndt_align_kernelILi{m}ELi{ls}E", name)
                 for (m, ls), name in NDT_INSTANCES.items()),
               ("pgo_cg_kernelILb0E", "pgo"),
               ("pgo_cg_kernelILb1E", "pgo jacobi"),
               ("pgo_cg_first_kernel", "pgo first version"),
               *((f"ndt_pass_kernelILi{m}E", "ndt pass" if m == 7 else f"ndt pass {m}")
                 for m in (1, 7, 27)),
               ("icp_partial_kernel", "icp partial"),
               ("icp_solve_kernel", "icp solve"),
               ("icp_step_kernel", "icp step"),
               ("icp_step_first_kernel", "icp step first version"),
               ("icp_init_kernel", "icp init"),
               ("icp_fitness_kernel", "icp fitness"),
               ("guess_kernel", "guess"))   # the probe kernels are not listed
# the instantiations that spill registers (ptxas for sm_90a with CUDA 12.8),
# 12 bytes each: DIRECT7 and DIRECT1 with backtracking, DIRECT7 with
# More-Thuente and the 27-cube with More-Thuente and the clamped step; ptxas
# moves such spills between instantiations on small edits; no other kernel
# may spill
SPILL_EXEMPT = ("ndt align", "ndt align 1 backtrack", "ndt align 7 mt_exact",
                "ndt align 27 mt_exact", "ndt align 27 ref_clamped")


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

    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                             pgo_kernel)

    from xchu_slam_tpu_torch.io import native_loader

    builds = (nn_kernel.build, ndt_kernel.build, pgo_kernel.build, pgo_kernel.build_first,
              icp_kernel.build, icp_kernel.build_first, guess_kernel.build,
              native_loader.build)
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
    spills = [n for n, f in figures.items() if f["spill_bytes"] and n not in SPILL_EXEMPT]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
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


# FP32 operations of the NDT kernel's passes, per source point with m valid
# neighbours (a multiply-add counts 2): the Hessian pass forms Bδ, δᵀBδ, the
# exponential, a6 and the 21 + 9 running sums per pair (~75 multiply-adds each)
# and J-terms once per point (~150); the gradient pass ~30 per pair and ~40
# per point; the fitness pass ~6 per pair.
def ndt_flop(m: int) -> tuple[int, int, int]:
    """(Hessian pass, gradient pass, fitness pass) FP32 operations a point."""
    return 2 * (m * 75 + 150), 2 * (m * 30 + 40), 2 * (m * 6 + 10)


NDT_ALIGNS = 64
NDT_POSE_TOL = 1e-4      # m and rad, per align from the host engine's own state
NDT_PASS_TOL = 1e-5      # of the largest |entry| of (L, g, H): the sums' order differs


def ndt_bound_ms(n: int, iterations: float, trials: float,
                 m: int = 7) -> tuple[float, str, float, float]:
    """The least time the card could take for one align with this run's trip
    counts: bytes (source points, mask and the m gathered rows of each point
    read once, the record written once) at 3.35 TB/s against the passes' FP32
    operations at 67 TFLOP/s. Returns (bound, what bounds it, bytes ms,
    operations ms). Neither reaches a microsecond: what the kernel really
    waits for is latency, which `ndt_latency_floor` measures."""
    hess, grad, fit = ndt_flop(m)
    bytes_ms = 1e3 * (n * 12 + n + n * m * 40 + 64 * 4) / HBM_BYTES_PER_S
    flop = n * (iterations * hess + trials * grad + fit)
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


GUESS_SCANS = 64           # the circuit's windows the guess kernel is held on
GUESS_TOL = 1e-5           # m and rad, m/s: the kernel against its plain chain
GUESS_SAME_ITERS = 0.9     # share of aligns with the same Newton count from either guess
GUESS_CHAIN_REPS = 64      # chains per launch of the chain probe
# FP32 operations of one guess (a multiply-add counts 2): per sample and
# chain, Euler angles to a rotation (~20), the 3×3 product (15), the
# integration (~15), and six sines / cosines and three atan2 of the wraps
# plus six sincos of the rotation, counted at ~20 operations each (their
# accurate library forms): ~50 + 15 × 20 = 350, for 2 chains of 16 samples
GUESS_OPS = 2 * 16 * 350


def phase_guess_kernel(smi: str) -> dict:
    """The guess kernel against its plain chain (`imu.ext_guess_ref`) on the
    card over the circuit's first 64 IMU + wheel windows, each from the pose
    and velocity an engine would hold there (the on-device odometry stepped
    with the kernel's guess, the velocity reset from its delta); the NDT
    iteration counts from either guess; reruns bit-identical. Then µs per
    launch from CUDA-graph replays, the plain chain's time and kernel count
    inside a graph, the bound and the latency floor (an empty 1 × 32 launch
    + the dependent chain, from the source's probe kernel)."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.ops import imu, ndt
    from xchu_slam_tpu_torch.ops.cuda import guess_kernel
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import make_cloud
    from xchu_slam_tpu_torch.utils import sim

    dev = torch.device("cuda")
    cfg = cli.sim_config(imu=True, wheel=True)
    gt_stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    wins, _alts = cli._sim_feeds(cfg, gt, gt_stamps, np.random.default_rng(SEED))
    lazy = sim.RenderedScans(world, gt, seed=SEED, n_points=24_000)
    ospec = odometry.spec_from_config(cfg)

    def filtered(i):
        return filter_scan(make_cloud(*lazy[i], capacity=cfg.filter.max_raw_points,
                                      device=dev), cfg.filter)

    def window(i):
        return (imu.ImuWindow(*(torch.from_numpy(a[i]).to(dev) for a in wins["imu"])),
                imu.OdomWindow(*(torch.from_numpy(a[i]).to(dev) for a in wins["wheel"])))

    f0 = filtered(0)
    state = odometry.init_state(ospec, torch.zeros(6, device=dev), f0.xyz, f0.mask)
    vel = torch.zeros(3, device=dev)
    err, same_iters, mismatched = 0.0, 0, []
    guess_kernel.launches = 0
    for i in range(1, GUESS_SCANS + 1):
        iw, ww = window(i)
        got = imu.ext_guess(state.pose, iw, ww, vel, True, True)
        again = imu.ext_guess(state.pose, iw, ww, vel, True, True)
        want = imu.ext_guess_ref(state.pose, iw, ww, vel, True, True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)) \
                or bool(got[1]) != bool(want[1]):
            raise AssertionError(f"guess_kernel: window {i}: a rerun differs or use_ext "
                                 f"{bool(got[1])} against {bool(want[1])}")
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float((got[2] - want[2]).abs().max()))
        f = filtered(i)
        new_state, out = odometry.step(state, f.xyz, f.mask, ospec, got[0], got[1],
                                       on_device=True)
        plain_guess = odometry._guess(state, torch.where(want[1], want[0], state.diff))
        res = ndt.align(state.grid_a, f.xyz, f.mask, plain_guess, ospec.gspec, ospec.nspec)
        if int(out.iterations) == int(res.iterations):
            same_iters += 1
        else:
            mismatched.append((i, int(out.iterations), int(res.iterations)))
        dt = float(gt_stamps[i] - gt_stamps[i - 1])
        vel = (out.pose[:3] - state.pose[:3]) / torch.full((), dt, device=dev)
        state = new_state
    torch.cuda.synchronize()
    launches = guess_kernel.launches
    if launches != 2 * GUESS_SCANS or not err <= GUESS_TOL \
            or same_iters < GUESS_SAME_ITERS * GUESS_SCANS:
        raise AssertionError(f"guess_kernel: {launches} launches, max |Δ| {err:.3g} (> "
                             f"{GUESS_TOL}?), the same Newton count from either guess on "
                             f"{same_iters} of {GUESS_SCANS}: {mismatched}")
    iw, ww = window(GUESS_SCANS)
    pose, v = state.pose.clone(), vel.clone()
    ms = _graph_ms(lambda: imu.ext_guess(pose, iw, ww, v, True, True))
    plain_ms = _graph_ms(lambda: imu.ext_guess_ref(pose, iw, ww, v, True, True),
                         calls=5, replays=5)
    plain = _profile_window(lambda: imu.ext_guess_ref(pose, iw, ww, v, True, True), 1)
    host_us = _host_us(lambda: imu.ext_guess(pose, iw, ww, v, True, True))
    out_t = torch.ones(2, device=dev)
    m = iw.stamps.shape[0]
    launch_ms = _graph_ms(lambda: guess_kernel.probe("launch", 0, m, out_t), calls=PROBE_CALLS)
    chain_n = _graph_ms(lambda: guess_kernel.probe("chain", GUESS_CHAIN_REPS, m, out_t),
                        calls=PROBE_CALLS)
    chain_ms = (chain_n - launch_ms) / GUESS_CHAIN_REPS
    floor_ms = launch_ms + chain_ms
    nbytes = 24 + 12 + 2 * m * (4 + 12 + 12 + 1) + 24 + 1 + 12
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * GUESS_OPS / FP32_FLOPS
    bound_ms, bound_by = max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"
    print(f"guess_kernel [{smi}]: {GUESS_SCANS} of the circuit's IMU + wheel windows from "
          f"the odometry's own poses: max |Δ| {err:.3g} against the plain chain (tolerance "
          f"{GUESS_TOL}), reruns bit-identical, the same Newton count from either guess "
          f"on {same_iters} of {GUESS_SCANS}; {ms * 1e3:.3f} us a launch (CUDA-graph "
          f"replays), wrapper host cost {host_us:.2f} us; plain chain {plain_ms:.4f} ms "
          f"in a graph, {plain['device_kernels_per_scan']:.0f} kernels; bound "
          f"{bound_ms:.7f} ms by {bound_by}; floor: empty 1 x 32 launch {launch_ms:.5f} ms "
          f"+ the dependent chain of {m} samples {chain_ms:.5f} ms = {floor_ms:.5f} ms "
          f"({100 * floor_ms / ms:.1f} % of it reached)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "host_us": host_us,
            "plain_kernels": plain["device_kernels_per_scan"],
            "same_iterations": same_iters, "windows": GUESS_SCANS,
            "latency_floor_ms": floor_ms, "floor": {"launch_ms": launch_ms,
                                                     "chain_ms": chain_ms}}


def _count_launches(fn):
    """(fn's result, {"nn", "ndt", "pgo", "icp_step", "guess", "icp_live_trips"}:
    the launches of each kernel it made, and the ICP iterations that were
    live): the counts are set to 0 just before and read just after."""
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                             pgo_kernel)

    ndt_kernel.launches = nn_kernel.launches = pgo_kernel.launches = icp_kernel.launches = 0
    guess_kernel.launches = 0
    trips = icp.live_trip_count()
    out = fn()
    return out, {"nn": nn_kernel.launches, "ndt": ndt_kernel.launches,
                 "pgo": pgo_kernel.launches, "icp_step": icp_kernel.launches,
                 "guess": guess_kernel.launches,
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


def phase_main(record: dict | None = None) -> tuple[dict, dict]:
    """The circuit through the host engine. With `record` (a dict), it also
    keeps what the mesh phase replays: the first MESH_ALIGNS aligns' inputs
    and results, every Scan Context retrieval's query and result, the
    verifications, and the pipeline (clones on the card, no readback)."""
    from xchu_slam_tpu_torch.cli import pose_hash, run_sim
    from xchu_slam_tpu_torch.ops import icp, ndt, scancontext as sc

    calls, align = [], icp.align
    aligns, ndt_align, queries, detect = [], ndt.align, [], sc.detect_loop_on_device

    def recording_align(*args, **kw):
        res = align(*args, **kw)
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                      res))
        return res

    def recording_ndt(grid, xyz, mask, guess, gspec, nspec, mesh=None):
        res = ndt_align(grid, xyz, mask, guess, gspec, nspec, mesh=mesh)
        if len(aligns) < MESH_ALIGNS:
            aligns.append(((grid.fin.clone(), grid.origin.clone(), xyz.clone(), mask.clone(),
                            guess.clone(), gspec, nspec), res))
        return res

    def recording_detect(query, db, db_count, spec, cur=None, mesh=None):
        res = detect(query, db, db_count, spec, cur, mesh)
        queries.append(((query.clone(), db_count, cur, spec), res))
        return res

    icp.align = recording_align
    if record is not None:
        ndt.align, sc.detect_loop_on_device = recording_ndt, recording_detect
    try:
        (pipe, summary), counts = _count_launches(
            lambda: run_sim(SCANS, RADIUS, SEED, "cuda"))
    finally:
        icp.align, ndt.align, sc.detect_loop_on_device = align, ndt_align, detect
    if record is not None:
        record.update(aligns=aligns, queries=queries, verifications=list(calls), pipe=pipe)
    replay = _replay_verifications(calls)
    print("main: the circuit's verifications again through align_ref " + json.dumps(replay))
    launches = counts["nn"]
    odo = pipe.odometry_trajectory()
    _, _, kf_opt = pipe.keyframe_trajectory()
    _check_loop_kernels("main", counts, pipe.icp_verifications, summary["loops"],
                        _inloop_gn(pipe))
    summary.update(pose_hash=pose_hash(pipe),
                   icp_verifications=pipe.icp_verifications, nn_launches=launches,
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


def _check_stage_spans(pipe, summary: dict) -> None:
    """The device engine's `stage_seconds` against the CLI's attribution:
    the `chunk` spans cover the chunks' dispatch times, and the three keys
    the benchmark's first readers read (`OLD_STAGES`, with the seed) lie
    inside them, near all of them."""
    from xchu_slam_tpu_torch.models.device_pipeline import OLD_STAGES

    st, att = pipe.stage_seconds, summary["chunk_attribution"]
    dispatch = 1e-3 * att["mean_dispatch_ms"] * att["chunks"]
    old = sum(st[k] for k in OLD_STAGES)
    inside = old + st["session.seed"]
    if not (abs(st["chunk"] - dispatch) <= 0.02 * dispatch + 0.005
            and inside <= st["chunk"] and inside >= 0.9 * st["chunk"]):
        raise AssertionError(f"device: spans {st} against the attribution {att}")
    for k in OLD_STAGES:
        if abs(summary["stage_seconds"][k] - st[k]) > 1e-3:
            raise AssertionError(f"device: stage_seconds[{k!r}] {st[k]} against the "
                                 f"summary's {summary['stage_seconds'][k]}")
    print(f"device: spans match the attribution: chunk {st['chunk']:.3f} s against "
          f"{dispatch:.3f} s dispatched, the three old keys and the seed {inside:.3f} s; "
          f"Part B by stage " + json.dumps(summary["part_b_stages"]))


def phase_device_engine(host_summary: dict) -> dict:
    """The device engine through the CLI's functions at full width, and what
    its Part A costs. Returns the launches of both kernels by path."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.models.device_pipeline import PART_A_PHASES, DeviceSlamPipeline

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
    # Part A's phase events, read after each chunk's readback under check_sync
    samples = pipe.stage_seconds.get("device.samples", 0)
    phases = {k: pipe.stage_seconds.get(k, 0.0) for k, _a, _b in PART_A_PHASES}
    if samples != n_chunks or not all(0.0 < v < samples for v in phases.values()):
        raise AssertionError(f"device: Part A's phase events read {samples} samples over "
                             f"{n_chunks} chunks: {phases}")
    print("device: Part A by phase under check_sync, device ms a sampled scan "
          + json.dumps({k: round(1e3 * v / samples, 4) for k, v in phases.items()}))
    # Part A alone, 16 replays, on the finished engine
    clouds, stamps, _n = chunks[-1]
    one = type(clouds)(*(t[0] for t in clouds))
    stamp = torch.zeros((), device="cuda")
    prof_a = _profile_window(
        lambda: [pipe._run_part_a(one, stamp) for _ in range(DEV_CHUNK)], DEV_CHUNK)
    print("device: 4 warm chunks (Part A + readback + Part B) " + json.dumps(prof))
    print("device: Part A alone, 16 replays " + json.dumps(prof_a))
    del pipe
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
        _check_stage_spans(pipe, summary)
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
        single = _single_reference(pipe, summary)
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
            "profile": prof, "profile_part_a": prof_a, "summary": summary,
            "chunks": chunks, "single": single}


BATCH_SIZES = (1, 4, 8)
BATCH_SCANS = 32           # scans a member: two staged chunks
RESUME_CHUNKS = 2
MIN_NEW_KEYFRAMES = 20
RELOC_TOL_M = 2.0


def _cross_session_loops(pipe, k0: int) -> int:
    n = pipe.loop_count
    li = pipe.graph.loop_i[:n].cpu().numpy()
    lj = pipe.graph.loop_j[:n].cpu().numpy()
    return int(((li < k0) & (lj >= k0)).sum())


def phase_device_session(smi: str, dev_rec: dict) -> dict:
    """The device engine as a whole session through the CLI's functions at
    full width: `run-sim --engine device --loop-method isc --imu --wheel
    --gps --checkpoint-every 200 --out <tmp>` (the guess kernel on every
    scan but the first); the same circuit fed chunk by chunk with its
    windows under `set_sync_debug_mode("error")`, then Part A with windows
    alone under the profiler; the export read back and `eval`; `localize`
    against the device checkpoint; the checkpoint resumed for 2 chunks, bit
    for bit; `run-sim --continue-session` of it; `batch_step` at B = 1, 4, 8.
    Returns the launches of every kernel by path."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline
    from xchu_slam_tpu_torch.types import Cloud
    from xchu_slam_tpu_torch.utils import checkpoint, sim
    from xchu_slam_tpu_torch.utils.profiling import StageTimers

    chunks = dev_rec["chunks"]
    n_chunks = len(chunks)
    cfg = cli.sim_config(loop_method="isc", imu=True, wheel=True, gps=True)
    gt_stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    wins, alts = cli._sim_feeds(cfg, gt, gt_stamps, np.random.default_rng(SEED))

    def feed_args(c):
        """process_chunk's arguments for staged chunk c, as run-sim makes them."""
        clouds, _stamps, n_real = chunks[c]
        idx = np.minimum(c * DEV_CHUNK + np.arange(DEV_CHUNK), SCANS - 1)
        return clouds, gt_stamps[idx], n_real, alts[idx], cli._slice_windows(wins, idx)

    # the circuit chunk by chunk with its windows, Part B included, under sync
    # debug mode "error"; then Part A with windows alone under the profiler
    pipe = DeviceSlamPipeline(cfg, log_capacity=8192, device="cuda", check_sync=True)

    def checked():
        for c in range(n_chunks):
            pipe.process_chunk(*feed_args(c))
        pipe.finalize()

    _, checked_counts = _count_launches(checked)
    if pipe.chunk_readbacks != n_chunks or pipe.scan_count != SCANS \
            or checked_counts["guess"] != SCANS - 1:
        raise AssertionError(f"device session (checked): {pipe.chunk_readbacks} readbacks "
                             f"over {n_chunks} chunks, {pipe.scan_count} scans, "
                             f"{checked_counts['guess']} guess launches")
    checked_odo = pipe.odometry_trajectory()
    clouds, _stamps, _n = chunks[-1]
    one = Cloud(*(t[0] for t in clouds))
    stamp = torch.full((), float(gt_stamps[-1]) + 0.1, device="cuda")
    win = cli._slice_windows(wins, np.array([SCANS - 1]))
    win = type(win)(*(type(w)(*(torch.from_numpy(a[0]).cuda() for a in w)) for w in win))
    prof_a = _profile_window(
        lambda: [pipe._run_part_a(one, stamp, win) for _ in range(DEV_CHUNK)], DEV_CHUNK)
    print(f"device_session: the circuit's {n_chunks} chunks with IMU + wheel windows, "
          f"Part B included, under set_sync_debug_mode('error') without raising: "
          f"{pipe.chunk_readbacks} readbacks (one a chunk), {pipe.kf_count} keyframes, "
          f"{pipe.loop_count} loops; launches " + json.dumps(checked_counts))
    print("device_session: Part A with windows alone, 16 replays " + json.dumps(prof_a))
    del pipe
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="xchu_device_session_") as tmp:
        timers = StageTimers("cuda")
        (pipe, summary), counts = _count_launches(lambda: cli.run_sim(
            SCANS, RADIUS, SEED, "cuda", loop_method="isc", imu=True, wheel=True, gps=True,
            out=tmp, checkpoint_every=CHECKPOINT_EVERY, timers=timers, engine="device",
            chunk=DEV_CHUNK))
        paths = summary.pop("artifacts")
        _check_loop_kernels("device session", counts, pipe.icp_verifications,
                            summary["loops"], _inloop_gn(pipe))
        odo = pipe.odometry_trajectory()
        summary.update(icp_verifications=pipe.icp_verifications, nn_launches=counts["nn"],
                       ndt_launches=counts["ndt"], pgo_launches=counts["pgo"],
                       icp_step_launches=counts["icp_step"], guess_launches=counts["guess"],
                       gps_factors=int(pipe.graph.gps_mask.sum()),
                       chunk_readbacks=pipe.chunk_readbacks,
                       mean_newton_iterations=round(float(np.mean(
                           [r["iterations"] for r in pipe.odom_log[1:]])), 3),
                       constant_velocity_mean_newton_iterations=dev_rec["summary"][
                           "mean_newton_iterations"],
                       checked_run_max_abs_dpose=float(np.abs(checked_odo - odo).max()))
        print("device_session: " + json.dumps(summary))
        print(timers.report(), file=sys.stderr)
        if odo.shape != (SCANS, 6) or not np.isfinite(odo).all():
            raise AssertionError("device session: trajectory has the wrong shape or "
                                 "non-finite poses")
        if counts["ndt"] < SCANS - 1 or counts["guess"] < SCANS - 1:
            raise AssertionError(f"device session: {counts['ndt']} NDT and "
                                 f"{counts['guess']} guess launches over {SCANS} scans")
        if summary["loops"] < 1 or not summary["ate_rmse_m"] < 1.0:
            raise AssertionError(f"device session: {summary['loops']} loops, aligned ATE "
                                 f"{summary['ate_rmse_m']} m")
        if pipe.chunk_readbacks != summary["chunk_attribution"]["chunks"]:
            raise AssertionError("device session: not one readback a chunk")

        # the export read back, and eval of it against the ground truth
        stamps, est = kitti.read_tum(paths["odom_tum"])
        with open(paths["odom_log"]) as f:
            log_rows = sum(1 for _ in f)
        if len(stamps) != summary["keyframes"] or not np.isfinite(est).all() \
                or log_rows != SCANS:
            raise AssertionError("device session: --out does not hold the run")
        cam_T = sim.camera_frame_transform()
        gt_path = os.path.join(tmp, "gt_tum.txt")
        gt_rel = cli._gt_in_map_frame(gt)
        kitti.write_tum(gt_path, gt_stamps, cam_T @ gt_rel @ np.linalg.inv(cam_T))
        ev = cli.evaluate(paths["odom_tum"], gt_path)
        print("device_session: eval " + json.dumps(ev))
        if ev["pairs"] != summary["keyframes"] \
                or abs(ev["ape_rmse_m"] - summary["ate_rmse_m"]) > 1e-3:
            raise AssertionError("device session: eval disagrees with the run's ATE")

        # localize fresh scans against the device checkpoint, read from disk
        ckpt = os.path.join(tmp, "checkpoint.npz")
        with np.load(ckpt) as f:
            saved_scans = int(f["state.scan_count"])
            saved_loops = int(f["state.loop_count"])
            saved_kf = int(f["state.db.count"])
        loc, loc_counts = _count_launches(lambda: cli.localize_sim(
            ckpt, QUERIES, SCANS, RADIUS, SEED, fitness_thresh=FITNESS_THRESH, device="cuda"))
        rows = loc.pop("results")
        loc.update(pos_err_m=[r.get("pos_err_m") for r in rows], launches=loc_counts)
        print("device_session: localize " + json.dumps(loc))
        if loc["localized"] < 1 or loc_counts["nn"] < 1 or not loc["median_err_m"] < 1.5:
            raise AssertionError(f"device session: localize {loc}")

        # the checkpoint resumed for 2 chunks, against the uninterrupted rows
        first = saved_scans // DEV_CHUNK

        def resume():
            again = checkpoint.load_checkpoint(ckpt)
            if not isinstance(again, DeviceSlamPipeline) or again._scans_fed != saved_scans:
                raise AssertionError("device session: the checkpoint is not a device "
                                     f"engine's at scan {saved_scans}")
            for c in range(first, first + RESUME_CHUNKS):
                again.process_chunk(*feed_args(c))
            again.finalize()
            return again.odometry_trajectory()

        got, resume_counts = _count_launches(resume)
        lo, hi = saved_scans, saved_scans + RESUME_CHUNKS * DEV_CHUNK
        if got.shape[0] != hi or not np.array_equal(got[lo:hi], odo[lo:hi]):
            raise AssertionError(f"device session: the resumed rows {lo}-{hi - 1} differ "
                                 f"by {np.abs(got[lo:hi] - odo[lo:hi]).max()}")
        print(f"device_session: checkpoint of scan {saved_scans} resumed for "
              f"{RESUME_CHUNKS} chunks, rows {lo}-{hi - 1} bit-identical to the "
              f"uninterrupted run; launches " + json.dumps(resume_counts))
        del pipe
        torch.cuda.empty_cache()

        # a second session continues the saved one
        (cpipe, csum), cont_counts = _count_launches(lambda: cli.run_sim(
            SCANS, RADIUS, SEED, "cuda", engine="device", chunk=DEV_CHUNK,
            continue_from=ckpt))
        csum.pop("artifacts", None)
        reloc_err = float(np.linalg.norm(cpipe.continuation["reloc_pose"][:3]
                                         - gt_rel[0, :3, 3]))
        cross = _cross_session_loops(cpipe, saved_kf)
        csum.update(reloc_err_m=round(reloc_err, 4), saved_loops=saved_loops,
                    cross_session_loops=cross, launches=cont_counts)
        print("device_session: continued " + json.dumps(csum))
        cont = csum["continuation"]
        if not reloc_err < RELOC_TOL_M or cont["new_keyframes"] < MIN_NEW_KEYFRAMES \
                or not csum["loops"] > saved_loops or not csum["ate_rmse_m"] < 1.0 \
                or cont_counts["guess"] < SCANS - 1:
            raise AssertionError(f"device session: the continuation is not right: {csum}")
        del cpipe
        torch.cuda.empty_cache()

    batch = _phase_batch(chunks)
    return {"paths": {"device_session": counts, "device_session_checked": checked_counts,
                      "device_localize": loc_counts, "device_resume": resume_counts,
                      "device_continue": cont_counts, "batch": batch["counts"]},
            "summary": summary, "profile_part_a": prof_a, "batch": batch}


def _phase_batch(chunks) -> dict:
    """`batch_step` at B = 1, 4, 8 at full width: member b steps through 32
    consecutive scans of the circuit from scan 48·b (staged chunks 3b and
    3b + 1, filtered once), each member bit-equal to its single on-device
    run; ms a step over 31 steps between one pair of CUDA events."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import batch_odometry, odometry
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import Cloud

    cfg = cli.sim_config()
    ospec = odometry.spec_from_config(cfg)
    nb = max(BATCH_SIZES)
    def scan(b, k):
        clouds = chunks[3 * b + k // DEV_CHUNK][0]
        return filter_scan(Cloud(*(t[k % DEV_CHUNK] for t in clouds)), cfg.filter)

    filt = [[scan(b, k) for k in range(BATCH_SCANS)] for b in range(nb)]
    zero = torch.zeros(6, device="cuda")
    single = []
    for b in range(nb):
        st = odometry.init_state(ospec, zero, filt[b][0].xyz, filt[b][0].mask)
        poses = []
        for k in range(1, BATCH_SCANS):
            st, out = odometry.step(st, filt[b][k].xyz, filt[b][k].mask, ospec, on_device=True)
            poses.append(out.pose)
        single.append(torch.stack(poses))
    rows, counts = [], None
    for B in BATCH_SIZES:
        xyz = [torch.stack([filt[b][k].xyz for b in range(B)]) for k in range(BATCH_SCANS)]
        mask = [torch.stack([filt[b][k].mask for b in range(B)]) for k in range(BATCH_SCANS)]

        def run():
            states = batch_odometry.batch_init(ospec, torch.zeros(B, 6, device="cuda"),
                                               xyz[0], mask[0])
            torch.cuda.synchronize()
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            poses = []
            for k in range(1, BATCH_SCANS):
                states, out = batch_odometry.batch_step(states, xyz[k], mask[k], ospec)
                poses.append(out.pose)
            z.record()
            z.synchronize()
            return torch.stack(poses, dim=1), a.elapsed_time(z) / (BATCH_SCANS - 1)

        (poses, ms), c = _count_launches(run)
        if B == max(BATCH_SIZES):
            counts = c
        same = all(torch.equal(poses[b], single[b]) for b in range(B))
        rows.append({"B": B, "ms_per_step": ms, "scans_per_sec": 1e3 * B / ms,
                     "members_bit_equal": same, "ndt_launches": c["ndt"]})
        if not same or c["ndt"] != B * (BATCH_SCANS - 1):
            raise AssertionError(f"batch_step at B = {B}: members bit-equal {same}, "
                                 f"{c['ndt']} NDT launches")
    print("batch: " + json.dumps(rows))
    return {"rows": rows, "counts": counts}


# the NDT modes other than the default (backtrack + direct7), as (ls_mode,
# neighbor_mode), and the `run-sim --set` of each circuit of the modes phase
NDT_MODES = (("backtrack", "direct1"), ("backtrack", "direct26"), ("backtrack", "kdtree"),
             ("mt_exact", "direct7"), ("ref_clamped", "direct7"))
MODE_SETTINGS = ("ndt.ls_mode=mt_exact", "ndt.ls_mode=ref_clamped", "ndt.neighbor_mode=direct1",
                 "ndt.neighbor_mode=direct26", "ndt.neighbor_mode=kdtree", "pgo.precond=jacobi")
MODE_SAME_COUNTS = 60     # of the 64 aligns: the plain version's iteration and trial counts
# an NDT mode's rerun: the circuit's first scans (4 chunks; the runs are
# prefix-stable), its odometry rows bit for bit against the whole run's; the
# PGO mode's rerun is the whole circuit, its loops' solves included
MODE_RERUN_SCANS = 64
# m and rad, on the aligns whose counts are equal. Where the plain version
# is not reproducible to it on another device (ref_clamped's fixed trans_eps/2
# step along a direction taken from a gradient near 0 is rounding-chaotic:
# the plain version on the CPU and on the card differ by up to 4.4e-4 on the
# circuit), the kernel must be no farther from the plain version on the card
# than the plain version on the CPU is
MODE_POSE_TOL = 2e-5
# the neighbourhood frozen within 0.3 (‖Δt‖ + 60·‖Δr‖): the Newton count of
# the plain version on ≥ 62 of the 64 aligns, |Δpose| ≤ 1e-5 on those
REGATHER_DIST, REGATHER_SAME, REGATHER_TOL = 0.3, 62, 1e-5
# block barriers of the jacobi PGO kernel: 11 a CG iteration (2 in the
# Hessian-vector product, 3 in each dot product, 1 in the preconditioner, 2
# updates) and 14 outside the loop; FP32 operations a live keyframe: the
# block's Cholesky (~70 multiply-adds) once, ~188 a CG iteration (PGO_FLOP_ITER
# less the two substitution links)
PGO_JAC_BARRIERS_ITER, PGO_JAC_BARRIERS_FIXED = 11, 14
PGO_JAC_FLOP_FACTOR = 2 * 70
PGO_JAC_FLOP_ITER = 2 * 188


def _mode_scans(cfg) -> list:
    """The circuit's first NDT_ALIGNS + 1 scans, filtered on the card (the
    host engine's render order)."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import make_cloud
    from xchu_slam_tpu_torch.utils import sim

    _stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    rng = np.random.default_rng(SEED)
    scans = []
    for i in range(NDT_ALIGNS + 1):
        xyz, inten = sim.render_scan(world, gt[i], rng, n_points=24_000)
        scans.append(filter_scan(make_cloud(xyz, inten, capacity=cfg.filter.max_raw_points,
                                            device="cuda"), cfg.filter))
    return scans


def phase_ndt_regather(smi: str, ptxas: dict, ndt_rec: dict) -> dict:
    """(a') The default instantiation `<7, backtrack>` with the neighbourhood
    frozen within `ndt.regather_dist` = REGATHER_DIST (a launch argument)
    against `align_ref` with it on the circuit's first 64 aligns, the state
    carried by the host engine's step with it: the same Newton count on ≥
    REGATHER_SAME, |Δpose| ≤ REGATHER_TOL on those, reruns bit-identical;
    Newton iterations a scan beside the default's on the same inputs, the
    last align's ms from CUDA-graph replays beside the default's on the same
    inputs and phase 4's, with the bound and the latency floor of its passes
    and iterations, and direct7_rows bit-equal to direct7 (the same
    instantiation) on every align."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.ops import ndt
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel

    dev = torch.device("cuda")
    cfg = cli.sim_config()
    slot = ndt_kernel.RECORD
    scans = _mode_scans(cfg)
    ospec = odometry.spec_from_config(cfg.override({"ndt.regather_dist": REGATHER_DIST}))
    g, nspec = ospec.gspec, ospec.nspec
    base = nspec._replace(regather_dist=0.0)
    rows_spec = base._replace(neighbor_mode="direct7_rows")
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    state = odometry.init_state(ospec, torch.zeros(6, device=dev), scans[0].xyz,
                                scans[0].mask)
    same, max_dpose, beyond, rows, base_rows, refused = 0, 0.0, [], [], [], 0
    for i in range(1, NDT_ALIGNS + 1):
        filt = scans[i]
        guess = odometry._guess(state)
        grid = state.grid_a
        args = (grid.fin, grid.origin, filt.xyz, filt.mask, guess, g)
        rec = ndt_kernel.align_record(*args, nspec, d1, d2)
        again = ndt_kernel.align_record(*args, nspec, d1, d2)
        rec0 = ndt_kernel.align_record(*args, base, d1, d2)
        rec_rows = ndt_kernel.align_record(*args, rows_spec, d1, d2)
        torch.cuda.synchronize()
        if not torch.equal(rec, again):
            raise AssertionError(f"ndt regather align {i}: a rerun is not bit-identical")
        if not torch.equal(rec0, rec_rows):
            raise AssertionError(f"ndt direct7_rows align {i}: not the bits of direct7")
        stats = {}
        want = ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec, stats=stats)
        refused += stats["stale_refusals"]
        rec_h = rec.cpu().numpy()
        it = int(rec_h[slot["iterations"]])
        rows.append((it, int(rec_h[slot["trials"]]), int(rec_h[slot["passes"]])))
        base_rows.append(int(rec0[slot["iterations"]]))
        if it == int(want.iterations):
            same += 1
            dpose = float(np.abs(rec_h[slot["pose"]] - want.pose.cpu().numpy()).max())
            max_dpose = max(max_dpose, dpose)
            if dpose > REGATHER_TOL:
                beyond.append((i, it, dpose))
        state, _out = odometry.step(state, filt.xyz, filt.mask, ospec)
    # the last align, with the neighbourhood frozen and gathered every iteration
    ms = _graph_ms(lambda: ndt_kernel.align_record(*args, nspec, d1, d2), calls=20)
    ms0 = _graph_ms(lambda: ndt_kernel.align_record(*args, base, d1, d2), calls=20)
    plain_ms = _host_ms(lambda: ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec),
                        reps=3)
    last = rows[-1]
    n = int(filt.xyz.shape[0])
    bound_ms, bound_by, _b, _o = ndt_bound_ms(n, last[0], last[1], 7)
    blocks, _trips = ndt_kernel.plan(n, ndt_kernel.max_blocks(0), ndt_kernel.LANES["direct7"])
    launch_ms, barrier_ms = _grid_barrier(blocks, ndt_kernel.THREADS)
    floor = ndt_rec["floor"]
    floor_ms = (launch_ms + last[2] * (barrier_ms + floor["l2_hop_ms"])
                + last[0] * floor["control_ms"])
    rec_m = {"regather_dist": REGATHER_DIST, "aligns": NDT_ALIGNS, "same_counts": same,
             "max_abs_err": max_dpose, "beyond_tol": beyond,
             "stale_refusals_plain": refused,
             "mean_iterations": float(np.mean([r[0] for r in rows])),
             "mean_iterations_default": float(np.mean(base_rows)),
             "mean_trials": float(np.mean([r[1] for r in rows])),
             "ms": ms, "default_ms_same_call": ms0, "phase4_ms": ndt_rec["ms"],
             "last_align": {"iterations": last[0], "trials": last[1], "passes": last[2],
                            "default_iterations": base_rows[-1]},
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "latency_floor_ms": floor_ms, "direct7_rows_bit_equal": NDT_ALIGNS,
             "ptxas": ptxas["ndt align"]}
    print(f"ndt_modes [{smi}]: backtrack+direct7 regather_dist={REGATHER_DIST}: " +
          json.dumps(rec_m))
    if same < REGATHER_SAME or beyond:
        raise AssertionError(f"ndt regather: the plain version's Newton count on {same} of "
                             f"{NDT_ALIGNS} (< {REGATHER_SAME}) or |Δpose| beyond "
                             f"{REGATHER_TOL}: {beyond}")
    return rec_m


def phase_ndt_modes(smi: str, ptxas: dict, floor: dict) -> dict:
    """(a) Each non-default NDT mode's kernel instantiation against
    `align_ref` in that mode on 64 of the circuit's aligns at full width, the
    state carried by the host engine's step in that mode: the same iteration
    and trial counts on ≥ 60, |Δpose| ≤ 2e-5 where they are equal (or, on
    an align where the plain version on the CPU is farther than that from
    itself on the card, no farther than it), reruns bit-identical; ms an align from CUDA-graph replays, the bound by bytes
    (rows gathered × M), the latency floor (launch + passes × (barrier at the
    mode's geometry + L2 round trip) + iterations × control, the round trip
    and the control step from phase 4), ptxas's figures."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.ops import ndt
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel

    dev = torch.device("cuda")
    cfg = cli.sim_config()
    slot = ndt_kernel.RECORD
    scans = _mode_scans(cfg)
    out = {}
    for ls, nb in NDT_MODES:
        name = f"{ls}+{nb}"
        ospec = odometry.spec_from_config(cfg.override({"ndt.ls_mode": ls,
                                                        "ndt.neighbor_mode": nb}))
        g, nspec = ospec.gspec, ospec.nspec
        d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
        state = odometry.init_state(ospec, torch.zeros(6, device=dev), scans[0].xyz,
                                    scans[0].mask)
        same, max_dpose, rows, spread = 0, 0.0, [], []
        for i in range(1, NDT_ALIGNS + 1):
            filt = scans[i]
            guess = odometry._guess(state)
            grid = state.grid_a
            args = (grid.fin, grid.origin, filt.xyz, filt.mask, guess, g, nspec, d1, d2)
            rec = ndt_kernel.align_record(*args)
            again = ndt_kernel.align_record(*args)
            torch.cuda.synchronize()
            if not torch.equal(rec, again):
                raise AssertionError(f"ndt {name} align {i}: a rerun is not bit-identical")
            stats = {}
            want = ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec, stats=stats)
            rec_h = rec.cpu().numpy()
            if not np.isfinite(rec_h[:12]).all():
                raise AssertionError(f"ndt {name} align {i}: record {rec_h[:12]}")
            it, tr = int(rec_h[slot["iterations"]]), int(rec_h[slot["trials"]])
            rows.append((it, tr, int(rec_h[slot["passes"]])))
            if it == int(want.iterations) and tr == stats["trials"]:
                same += 1
                want_h = want.pose.cpu().numpy()
                dpose = float(np.abs(rec_h[slot["pose"]] - want_h).max())
                if dpose > MODE_POSE_TOL:
                    # the plain version's own spread on this align: on the CPU
                    cpu = ndt.align_ref(type(grid)(*(t.cpu() for t in grid)), filt.xyz.cpu(),
                                        filt.mask.cpu(), guess.cpu(), g, nspec)
                    own = float(np.abs(cpu.pose.numpy() - want_h).max())
                    spread.append((i, it, dpose, own))
                    if not dpose <= own:
                        raise AssertionError(
                            f"ndt {name} align {i}: |Δpose| {dpose:.3g} against the plain "
                            f"version on the card, > {MODE_POSE_TOL} and > the plain "
                            f"version's own spread to the CPU, {own:.3g}")
                else:
                    max_dpose = max(max_dpose, dpose)
            state, _out = odometry.step(state, filt.xyz, filt.mask, ospec)
        if same < MODE_SAME_COUNTS:
            raise AssertionError(f"ndt {name}: the plain version's counts on {same} of "
                                 f"{NDT_ALIGNS} (< {MODE_SAME_COUNTS})")
        ms = _graph_ms(lambda: ndt_kernel.align_record(*args), calls=20)
        pass_ms = _graph_ms(lambda: ndt_kernel.hessian_pass(*args), calls=20)
        plain_ms = _host_ms(lambda: ndt.align_ref(grid, filt.xyz, filt.mask, guess, g, nspec),
                            reps=3)
        n = int(filt.xyz.shape[0])
        m = ndt_kernel.NEIGHBOURS[nb]
        last = rows[-1]
        bound_ms, bound_by, bytes_ms, ops_ms = ndt_bound_ms(n, last[0], last[1], m)
        blocks, trips = ndt_kernel.plan(n, ndt_kernel.max_blocks(0, nb, ls),
                                        ndt_kernel.LANES[nb])
        launch_ms, barrier_ms = _grid_barrier(blocks, ndt_kernel.THREADS)
        floor_ms = (launch_ms + last[2] * (barrier_ms + floor["l2_hop_ms"])
                    + last[0] * floor["control_ms"])
        figures = ptxas[NDT_INSTANCES[(m, ndt_kernel.LINE_SEARCHES[ls])]]
        rec_m = {"aligns": NDT_ALIGNS, "same_counts": same,
                 "max_abs_err": max([max_dpose] + [d for _i, _it, d, _o in spread]),
                 "max_abs_err_within_tol": max_dpose,
                 "beyond_tol_within_plain_spread": [
                     {"align": i, "iterations": it, "abs_err": d, "plain_cpu_vs_card": o}
                     for i, it, d, o in spread],
                 "mean_iterations": float(np.mean([r[0] for r in rows])),
                 "mean_trials": float(np.mean([r[1] for r in rows])),
                 "ms": ms, "pass_ms": pass_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by,
                 "latency_floor_ms": floor_ms, "passes": last[2],
                 "geometry": f"{blocks}x{ndt_kernel.THREADS}x{trips}", "ptxas": figures}
        out[name] = rec_m
        beyond = "; ".join(f"align {i} ({it} iterations) {d:.3g} against the plain "
                           f"version's own {o:.3g} CPU to card" for i, it, d, o in spread)
        print(f"ndt_modes [{smi}]: {name}: {same} of {NDT_ALIGNS} aligns with the plain "
              f"version's iteration and trial counts, max |Δpose| {max_dpose:.3g} on "
              f"{same - len(spread)} of them{'; beyond ' + str(MODE_POSE_TOL) + ': ' + beyond if spread else ''}, "
              f"reruns bit-identical; mean {rec_m['mean_iterations']:.3f} iterations, "
              f"{rec_m['mean_trials']:.3f} trials; {ms:.5f} ms an align ({last[0]} "
              f"iterations, {last[1]} trials, {last[2]} passes; {blocks} blocks x "
              f"{ndt_kernel.THREADS} threads, {trips} trips), {pass_ms:.5f} ms a launch of "
              f"one Hessian pass (it gathers; the trials read shared memory); bound "
              f"{bound_ms:.5f} ms by "
              f"{bound_by} (bytes {bytes_ms:.5f}, operations {ops_ms:.5f}); latency floor "
              f"{floor_ms:.5f} ms (launch {launch_ms:.5f} + {last[2]} x (barrier "
              f"{barrier_ms:.5f} + L2 {floor['l2_hop_ms']:.6f}) + {last[0]} x control "
              f"{floor['control_ms']:.5f}: {100 * floor_ms / ms:.1f} % of it reached); "
              f"plain version {plain_ms:.3f} ms (host clock, median of 3); "
              f"ptxas {json.dumps(figures)}")
    return out


def _grid_barrier(blocks: int, threads: int) -> tuple[float, float]:
    """(empty cooperative launch ms, ms a grid.sync()) of blocks × threads,
    from the NDT source's grid probe in CUDA-graph replays."""
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel

    t0, t1, t5 = (_graph_ms(lambda r=r: ndt_kernel.probe("grid", r, blocks=blocks,
                                                         threads=threads), calls=PROBE_CALLS)
                  for r in (0, 1, 5))
    return t0, (t5 - t1) / 4


def phase_pgo_jacobi(smi: str, pgo_floor: dict) -> dict:
    """(b) The jacobi PGO kernel against `solve_ref` with jacobi at the
    circuit's in-loop spec on 2048 slots, 163 and 2048 live keyframes:
    |Δpose| ≤ 1e-4, reruns bit-identical, CG trips, ms a launch from CUDA-graph
    replays, bound and floor (launch + barriers, from phase 4b's probes)."""
    import pgo_cases
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models import pose_graph as pg
    from xchu_slam_tpu_torch.ops.cuda import pgo_kernel
    from xchu_slam_tpu_torch.utils import se3

    dev = torch.device("cuda")
    spec = pg.inloop_spec(pg.spec_from_config(
        cli.sim_config(("pgo.precond=jacobi",)).pgo))
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
            raise AssertionError(f"pgo jacobi {name}: |Δpose| {err:.3g} (> {PGO_TOL}), "
                                 f"moved {moved:.3g}, rerun equal {torch.equal(got, again)}")
        s = pg._gn_system(se3.pose_to_matrix(p_d), g_d, spec)
        args = (s.blocks.contiguous(), s.U.contiguous(), s.g.contiguous(), s.Ji.contiguous(),
                s.Jj.contiguous(), s.odom_info, s.wp, s.Jli.contiguous(), s.Jlj.contiguous(),
                g_d.loop_i, g_d.loop_j, s.wl.contiguous(), s.A.contiguous(),
                s.gz.contiguous(), g_d.kf_mask, torch.ones((), dtype=torch.bool, device=dev),
                spec.cg_tol, spec.cg_iterations)
        _x, iters = pgo_kernel.cg(*args, precond="jacobi")
        it = int(iters)
        k1, k2 = (_graph_ms(lambda: pgo_kernel.cg(*args, precond="jacobi"), calls=10,
                            replays=5) for _ in range(2))
        ms = 0.5 * (k1 + k2)
        plain_ms = _host_ms(lambda: pg._pcg_ref(s, g_d, spec), reps=3)
        bytes_ms = 1e3 * (n_live * (PGO_BYTES_KF - 144) + n_loops * PGO_BYTES_LOOP
                          + 2048 * 24) / HBM_BYTES_PER_S
        ops_ms = 1e3 * n_live * (PGO_JAC_FLOP_FACTOR + it * PGO_JAC_FLOP_ITER) / FP32_FLOPS
        floor_ms = pgo_floor["launch_ms"] + (PGO_JAC_BARRIERS_ITER * it
                                             + PGO_JAC_BARRIERS_FIXED) * pgo_floor["barrier_ms"]
        rows[name] = {"live": n_live, "loops": n_loops, "cg_iterations": it,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                      "latency_floor_ms": floor_ms}
        print(f"pgo_jacobi [{smi}]: {name} ({n_live} live, {n_loops} loops, {it} CG "
              f"iterations of at most {spec.cg_iterations}): {ms:.5f} ms per launch "
              f"({k1:.5f}/{k2:.5f}); bound {max(bytes_ms, ops_ms):.6f} ms; floor "
              f"{floor_ms:.5f} ms (launch + {PGO_JAC_BARRIERS_ITER * it + PGO_JAC_BARRIERS_FIXED}"
              f" barriers: {100 * floor_ms / ms:.1f} % of it reached); plain factor + CG "
              f"{plain_ms:.3f} ms (host clock); |Δpose| {err:.3g}, reruns bit-identical")
    circ = rows["circuit"]
    return {**{k: circ[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "latency_floor_ms", "cg_iterations")}, "cases": rows}


def phase_mode_circuits() -> dict:
    """(c) The circuit through `run-sim --engine device --chunk 16` once in each
    mode (MODE_SETTINGS), then again (an NDT mode's first MODE_RERUN_SCANS
    scans): keyframes, loops, aligned ATE, Newton iterations and line-search
    trials a scan (the kernel records' trial slots summed on the card, inside
    Part A's graph), scans/s, the NDT and PGO launches; ≥ 1 loop, ATE < 1.0
    m, NDT launches ≥ one a scan, PGO launches for every accepted loop, the
    rerun bit-identical."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.ops.cuda import ndt_kernel

    align_record = ndt_kernel.align_record
    trials = torch.zeros((), device="cuda")

    def counting(*args, **kw):
        rec = align_record(*args, **kw)
        trials.add_(rec[ndt_kernel.RECORD["trials"]])   # captured with the align
        return rec

    out = {}
    ndt_kernel.align_record = counting
    try:
        for setting in MODE_SETTINGS:
            trials.zero_()
            (pipe, summary), counts = _count_launches(lambda: cli.run_sim(
                SCANS, RADIUS, SEED, "cuda", overrides=(setting,), engine="device",
                chunk=DEV_CHUNK))
            trials_per_scan = float(trials) / (SCANS - 1)
            traj = pipe.odometry_trajectory()
            kf = pipe.keyframe_trajectory()[2]
            iters = float(np.mean([r["iterations"] for r in pipe.odom_log[1:]]))
            _check_loop_kernels(f"device {setting}", counts, pipe.icp_verifications,
                                summary["loops"], _inloop_gn(pipe))
            del pipe
            torch.cuda.empty_cache()
            n_again = SCANS if setting.startswith("pgo.") else MODE_RERUN_SCANS
            again, _summary = cli.run_sim(n_again, RADIUS, SEED, "cuda", overrides=(setting,),
                                          engine="device", chunk=DEV_CHUNK)
            same = np.array_equal(again.odometry_trajectory(), traj[:n_again]) and (
                n_again < SCANS or np.array_equal(again.keyframe_trajectory()[2], kf))
            del again
            torch.cuda.empty_cache()
            row = {"setting": setting, "keyframes": summary["keyframes"],
                   "loops": summary["loops"], "ate_rmse_m": summary["ate_rmse_m"],
                   "mean_newton_iterations": round(iters, 3),
                   "trials_per_scan": round(trials_per_scan, 3),
                   "scans_per_sec": summary["scans_per_sec"], "ndt_launches": counts["ndt"],
                   "pgo_launches": counts["pgo"], "rerun_scans": n_again,
                   "rerun_bit_identical": same,
                   "launches": counts}
            out[setting] = row
            print("mode_circuit: " + json.dumps({k: v for k, v in row.items()
                                                  if k != "launches"}))
            if summary["loops"] < 1 or not summary["ate_rmse_m"] < 1.0 or not same \
                    or counts["ndt"] < SCANS - 1:
                raise AssertionError(f"the circuit with {setting}: {row}")
    finally:
        ndt_kernel.align_record = align_record
    return out


# the sources phase (11): each run in a fresh interpreter, whose render
# workers fork before its first CUDA call
SOURCES_MARK = "sources-child: "
SOURCES_PROCS = 3                  # render workers of the A/B
REALISM_HOST_SCANS = 120           # the host engine's realism run (render inline)
TRAJ_LAP, TRAJ_EXTRA, TRAJ_RADIUS = 320, 80, 40.0   # the TUM file: a lap + 80 scans
KITTI_SCANS, KITTI_RADIUS = 380, 45.0    # 316 m a lap: scans 316-379 revisit 0-63
KITTI_POINTS = 120_000             # HDL-64 density: default_config's 131,072 capacity is real
# rendered to 40 m in a world of 40 buildings: with 120,000 points spread to
# 60 m, the 0.5 m voxels overflow max_points and the radius filter leaves
# ~1,000 points, mostly ground, on which NDT does not hold its track
KITTI_RANGE, KITTI_BUILDINGS = 40.0, 40
KITTI_WRITERS = 6
SOURCES_TIMEOUT_S = 600
# the reference's "fast" stream configuration (bench.py:340-342)
FAST = {"overrides": ["filter.outlier_method=statistical_approx"], "prefetch_threads": 3,
        "prefetch_depth": 6, "render_procs": 5}
# the bucketed filter on the HDL-64-density files: buckets of 4 voxels (2 m,
# the default) and of 6 (3 m). At the default only ~20 % of this density's
# rows are proven, and the rows past the 1024 fallback rows are kept as
# unknown, outliers among them: run-kitti's loops then fail ICP's gate (on an
# H100, 0 loops of 68 verifications on the 380 files, where the radius
# filter closed 2). With 6 voxels the device run closes loops
BUCKET_MULTS = (4, 6)
BUCKETED = ("filter.outlier_method=statistical_bucketed", "filter.stat_bucket_mult=6")
BUCKET_FILES = 32          # the .bin files of the bucketed filter's comparison
BUCKET_NEAR = 1e-5         # relative: a mean distance this close to µ + m·σ may fall either side


def _knn_means(c, k: int, direct: bool) -> torch.Tensor:
    """Each valid row's mean distance to its k nearest, from all pairs: the
    direct difference Σ(q − c)² (the bucketed filter's main pass) or the
    expanded |q|² + |c|² − 2 q·c (the exact filter and the bucketed
    filter's fallback), so that a row's mean is computed as the filter that
    decided it computed it."""
    from xchu_slam_tpu_torch.ops import filter as F

    if not direct:
        # rows of 1024, the product's shape in the bucketed filter's fallback
        return F._chunked_pairwise(c.xyz, c.mask, 1024, lambda d2, m: torch.where(
            m, F._mean_knn(F._k_smallest(d2, k + 1)), torch.nan))
    out = []
    for i0 in range(0, c.xyz.shape[0], 1024):
        d2 = F._sq3(c.xyz[i0:i0 + 1024, None, :] - c.xyz[None, :, :])
        d2 = torch.where(c.mask[None, :], d2, torch.inf)
        out.append(torch.where(c.mask[i0:i0 + 1024], F._mean_knn(F._k_smallest(d2, k + 1)),
                               torch.nan))
    return torch.cat(out)


def _bucketed_against_exact(vdir: str, smi: str) -> dict:
    """The bucketed statistical filter against the exact one on the card, on
    the first BUCKET_FILES HDL-64-density files at run-kitti's config with
    buckets of each of BUCKET_MULTS voxels: the counts of proven,
    fallback-fixed and unknown rows, ms a scan of each outlier stage between
    CUDA events (the first file warms up), and the kept masks. Where every
    row is known the two masks agree but for points whose mean distance lies
    within BUCKET_NEAR (relative) of the threshold, where the two forms'
    roundings may fall either side. Unknown rows (past the fallback's rows)
    are kept and left out of µ and σ, which moves the threshold: so the
    bucketed mask is held to that rule on all-pairs means (each row's in the
    form that decided it: proven rows the direct difference, solved-again
    rows the expanded form; unknown rows kept, the others kept at or below
    the threshold of the known rows' means, but within BUCKET_NEAR of it),
    and the flags that differ from the exact filter's are counted."""
    from xchu_slam_tpu_torch.config import default_config
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.ops import filter as F
    from xchu_slam_tpu_torch.types import make_cloud

    fc = default_config().filter
    k = fc.stat_outlier_k
    files = kitti.list_velodyne_dir(vdir)[:BUCKET_FILES]
    zero = {"proven": 0, "fallback": 0, "unknown": 0}
    tally = {m: {"rows": dict(zero), "ms": [], "differ": 0, "near": 0, "kept": 0,
                 "against_exact": 0} for m in BUCKET_MULTS}
    exact_ms, points, kept_exact = [], 0, 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, passes):
        for _ in range(passes):
            ev[0].record()
            res = fn()
            ev[1].record()
        torch.cuda.synchronize()
        return res, ev[0].elapsed_time(ev[1])

    for f, path in enumerate(files):
        passes = 2 if f == 0 else 1
        raw = kitti.read_velodyne_bin(path)
        cloud = make_cloud(raw[:, :3], raw[:, 3], capacity=fc.max_raw_points, device="cuda")
        c = F.voxel_downsample(F.range_crop(cloud, fc.min_range, fc.max_range),
                               fc.voxel_size, fc.max_points)
        exact, t = timed(lambda: F.statistical_outlier_removal(c, k, fc.stat_outlier_stddev),
                         passes)
        exact_ms.append(t)
        points += int(c.mask.sum())
        kept_exact += int(exact.mask.sum())
        means = {form: _knn_means(c, k, form) for form in (True, False)}
        for mult in BUCKET_MULTS:
            rec, classes = tally[mult], {}
            bucketed, t = timed(lambda: F.statistical_outlier_removal_bucketed(
                c, k, fc.stat_outlier_stddev, mult * fc.voxel_size, mult ** 3,
                fc.stat_fallback_rows, classes=classes), passes)
            rec["ms"].append(t)
            for key in zero:
                rec["rows"][key] += int(classes[key].sum())
            # the threshold of the known rows' means
            mean_d = torch.where(classes["proven"], means[True], means[False])
            known = classes["proven"] | classes["fallback"]
            n = torch.clamp(known.sum(), min=1)
            mu = torch.sum(torch.where(known, mean_d, 0.0)) / n
            var = torch.sum(torch.where(known, (mean_d - mu) ** 2, 0.0)) / n
            t_known = mu + fc.stat_outlier_stddev * torch.sqrt(var)
            close = known & ((mean_d - t_known).abs() <= BUCKET_NEAR * t_known)
            rule = classes["unknown"] | (known & (mean_d <= t_known))
            off = (rule != bucketed.mask) & ~close
            if bool(off.any()):
                raise AssertionError(
                    f"bucketed filter ({mult} voxels), {os.path.basename(path)}: "
                    f"{int(off.sum())} kept flags off its rule outside the threshold band "
                    f"(rows {json.dumps({k: int(v.sum()) for k, v in classes.items()})})")
            rec["differ"] += int((rule != bucketed.mask).sum())
            rec["near"] += int(close.sum())
            rec["against_exact"] += int((exact.mask != bucketed.mask).sum())
            rec["kept"] += int(bucketed.mask.sum())
    out = {}
    for mult, rec in tally.items():
        out[mult] = {"card": smi, "bucket_voxels": mult, "files": len(files), "points": points,
                     "kept_bucketed": rec["kept"], "kept_exact": kept_exact,
                     "rows": rec["rows"], "differing_in_band": rec["differ"],
                     "in_band": rec["near"], "flags_differing_from_exact": rec["against_exact"],
                     "exact_ms_per_scan": float(np.median(exact_ms)),
                     "bucketed_ms_per_scan": float(np.median(rec["ms"]))}
        print("sources: statistical_bucketed against statistical on the card "
              + json.dumps(out[mult]))
    return out


def _write_kitti(root: str, n_scans: int = KITTI_SCANS) -> dict:
    """The closed circuit at HDL-64 density as KITTI velodyne `.bin` files
    (its first `n_scans`, rendered by forked workers) and its KITTI pose
    file (a row a scan, camera frame)."""
    from xchu_slam_tpu_torch.cli import _gt_in_map_frame
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.io.procsource import ProcessScanSource
    from xchu_slam_tpu_torch.utils import sim

    t0 = time.perf_counter()
    world = sim.make_world(SEED, extent=KITTI_RADIUS * 2.5, n_buildings=KITTI_BUILDINGS,
                           n_pillars=3 * KITTI_BUILDINGS, ground_pts=2_500_000,
                           wall_pts_per_face=12_000)
    gt = sim.loop_trajectory(n_scans=n_scans, radius=KITTI_RADIUS, speed=1.0)
    vdir = os.path.join(root, "velodyne")
    os.makedirs(vdir)
    points = []
    scans = sim.RenderedScans(world, gt, seed=SEED, n_points=KITTI_POINTS,
                              index=sim.WorldIndex(world), max_range=KITTI_RANGE)
    with ProcessScanSource(scans, workers=KITTI_WRITERS, readahead=8 * KITTI_WRITERS) as src:
        for k in range(n_scans):
            xyz, inten = src[k]
            np.c_[xyz, inten].tofile(os.path.join(vdir, f"{k:06d}.bin"))
            points.append(len(xyz))
    gt_cam = kitti.velo_to_cam(_gt_in_map_frame(gt))
    np.savetxt(os.path.join(root, "gt_kitti.txt"), gt_cam[:, :3, :4].reshape(-1, 12))
    return {"velodyne_dir": vdir, "gt": os.path.join(root, "gt_kitti.txt"),
            "scans": n_scans, "points_min": int(min(points)),
            "points_mean": round(float(np.mean(points)), 1),
            "seconds": round(time.perf_counter() - t0, 2)}


def sources_child(runs: list) -> None:
    """Run `runs` in this interpreter, one after another, through the CLI's
    functions; print one line: the marker, then a JSON list of each run's
    summary, launches and pose hash."""
    sys.path[:0] = [_HERE]
    from xchu_slam_tpu_torch import cli

    fns = {"run_sim": cli.run_sim, "run_kitti": cli.run_kitti, "localize": cli.localize_sim}
    # the device engine's per-chunk times, as the summary's attribution sees them
    seen, attribution = [], cli._chunk_attribution
    cli._chunk_attribution = lambda chunks, *a: (seen.append(chunks), attribution(chunks, *a))[1]
    out = []
    for run in runs:
        kind = run.pop("kind")
        if kind == "write_kitti":
            out.append(_write_kitti(**run))
            continue
        seen.clear()
        res, counts = _count_launches(lambda: fns[kind](**run))
        if kind == "localize":
            out.append({"summary": res, "launches": counts})
            continue
        pipe, summary = res
        summary.pop("artifacts", None)
        rec = {"summary": summary, "launches": counts, "pose_hash": cli.pose_hash(pipe),
               "icp_verifications": pipe.icp_verifications, "inloop_gn": _inloop_gn(pipe)}
        if seen:
            ch = seen[0]
            rec["wait_ms"] = [round(1e3 * t, 1) for t in ch["wait_s"]]
            rec["dispatch_ms"] = [round(1e3 * t, 1) for t in ch["dispatch_s"]]
            # the rate after the first chunk, which carries the process's
            # one-time starts (kernel loads, the first graph capture)
            ts, span = ch["ts"], ch["span"]
            rec["stream_after_chunk1_scans_per_sec"] = round(
                (span[-1][1] - span[0][1]) / (ts[-1] - ts[1]), 2)
        out.append(rec)
        del pipe
        torch.cuda.empty_cache()
    print(SOURCES_MARK + json.dumps(out))


def _sources_call(name: str, runs: list) -> list:
    """`runs` in a child interpreter (`--sources-child`); its results. The
    child's stderr is passed on; a failure of the child fails the phase."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--sources-child",
                           json.dumps(runs)], capture_output=True, text=True, cwd=_HERE,
                          timeout=SOURCES_TIMEOUT_S, check=False)
    sys.stderr.write(proc.stderr[-2000:])
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(SOURCES_MARK)]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"sources: {name} exited with code {proc.returncode}")
    return json.loads(lines[-1][len(SOURCES_MARK):])


def _write_lap_tum(path: str) -> None:
    """A closed lap of the port's own circuit, and its first TRAJ_EXTRA
    scans again, as a camera-frame TUM file stamped 0.1·i."""
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.utils import se3, sim

    lap = sim.closed_lap_trajectory(TRAJ_LAP, radius=TRAJ_RADIUS)
    poses = np.concatenate([lap, lap[:TRAJ_EXTRA]])
    cam = sim.camera_frame_transform()
    T = se3.pose_to_matrix(torch.from_numpy(poses.astype(np.float64))).numpy()
    kitti.write_tum(path, 0.1 * np.arange(len(poses)), cam @ T @ np.linalg.inv(cam))


def _check_source_run(name: str, rec: dict, scans: int, loops: bool = True,
                      ate: float = 1.0) -> None:
    s, c = rec["summary"], rec["launches"]
    print(f"sources: {name} " + json.dumps({**{k: s.get(k) for k in (
        "scans", "keyframes", "loops", "ate_rmse_m", "scans_per_sec", "stream_scans_per_sec",
        "render_procs", "inline_renders", "reader", "defer_sync")},
        "stream_after_chunk1_scans_per_sec": rec.get("stream_after_chunk1_scans_per_sec"),
        "launches": c, "pose_hash": rec["pose_hash"]}))
    _check_loop_kernels(f"sources {name}", c, rec["icp_verifications"], s["loops"],
                        rec["inloop_gn"])
    if c["ndt"] < scans - 1:
        raise AssertionError(f"sources {name}: {c['ndt']} NDT launches over {scans} scans")
    if loops and s["loops"] < 1:
        raise AssertionError(f"sources {name}: closed no loop")
    if not s.get("ate_rmse_m", 0.0) < ate:
        raise AssertionError(f"sources {name}: aligned ATE {s['ate_rmse_m']} m ≥ {ate} m")
    if s.get("inline_renders"):
        raise AssertionError(f"sources {name}: {s['inline_renders']} scans rendered inline")


def phase_sources(smi: str) -> dict:
    """Every scan source of the reference through the port's CLI functions,
    each run in a fresh interpreter: (1) the device engine on the circuit
    without and with render workers (pose hashes identical; the chunk wait
    and the streaming rate both ways); (2) the reference's "realism"
    configuration (device engine, 5 workers, 3 staging threads, depth 6),
    and realism through the host engine on a shorter run; (3) a TUM lap with
    IMU + wheel windows through the device engine with workers and a
    checkpoint, then `localize --trajectory` against it; (4) `run-kitti` on
    HDL-64-density `.bin` files written here: the host engine with and
    without `defer_sync` (poses identical) and the device engine, the reader
    native on each."""
    t0 = time.perf_counter()
    paths = {}
    dev = {"kind": "run_sim", "scans": SCANS, "radius": RADIUS, "seed": SEED,
           "device": "cuda", "engine": "device", "chunk": 16}
    # staging threads, then workers (two turns, not four: with four the whole
    # run took 1198.4 s of its 1200 s on one H100 machine)
    procs_run = {**dev, "render_procs": SOURCES_PROCS}
    ab = [_sources_call(name, [run])[0] for name, run in (
        ("device", dev), ("device --render-procs", procs_run))]
    for turn, rec in enumerate(ab):
        side = "procs" if rec["summary"].get("render_procs") else "threads"
        _check_source_run(f"device ({side}, turn {turn + 1})", rec, SCANS, ate=0.10)
        if rec["pose_hash"] != ab[0]["pose_hash"]:
            raise AssertionError("sources: the render workers changed the poses")
        att = rec["summary"]["chunk_attribution"]
        print(f"sources: A/B turn {turn + 1} {side} ({smi}) " + json.dumps({
            "mean_wait_ms": att["mean_wait_ms"], "mean_dispatch_ms": att["mean_dispatch_ms"],
            "p50_chunk_ms": att["p50_ms"], "stream_scans_per_sec":
            rec["summary"]["stream_scans_per_sec"], "stream_after_chunk1_scans_per_sec":
            rec["stream_after_chunk1_scans_per_sec"], "scans_per_sec":
            rec["summary"]["scans_per_sec"], "stage_seconds": rec["summary"]["stage_seconds"],
            "wait_ms": rec["wait_ms"], "dispatch_ms": rec["dispatch_ms"]}))
    paths["sources device"] = ab[0]["launches"]
    paths["sources device procs"] = ab[1]["launches"]

    # the reference's realism and "fast" configurations (a fork a fresh
    # interpreter: the first run initializes CUDA)
    (realism,) = _sources_call("realism", [{**dev, "realism": True, "render_procs": 5,
                                            "prefetch_threads": 3, "prefetch_depth": 6}])
    (fast,) = _sources_call("fast", [{**dev, **FAST}])
    _check_source_run("realism device --render-procs 5", realism, SCANS)
    paths["sources realism device"] = realism["launches"]
    _check_source_run("fast (statistical_approx, 5 workers, 3 threads, depth 6)", fast, SCANS,
                      ate=0.10)
    print(f"sources: fast ({smi}) warm rate (after chunk 1) "
          f"{fast['stream_after_chunk1_scans_per_sec']} scans/s beside the run with 3 "
          f"workers' {ab[1]['stream_after_chunk1_scans_per_sec']}; pose hash "
          f"{fast['pose_hash']} against {ab[1]['pose_hash']}")
    if fast["pose_hash"] != ab[1]["pose_hash"]:
        raise AssertionError("sources: the fast configuration changed the poses: its "
                             "statistical_approx filter is the exact one")
    paths["sources fast device"] = fast["launches"]

    with tempfile.TemporaryDirectory() as tmp:
        tum = os.path.join(tmp, "lap_tum.txt")
        _write_lap_tum(tum)
        session = os.path.join(tmp, "traj")
        traj, loc = _sources_call("trajectory", [
            {"kind": "run_sim", "trajectory": tum, "scans": 0, "seed": SEED, "device": "cuda",
             "engine": "device", "chunk": 16, "render_procs": SOURCES_PROCS, "imu": True,
             "wheel": True, "checkpoint_every": CHECKPOINT_EVERY, "out": session},
            {"kind": "localize", "session": os.path.join(session, "checkpoint.npz"),
             "trajectory": tum, "seed": SEED, "queries": QUERIES,
             "fitness_thresh": FITNESS_THRESH, "device": "cuda"}])
        n_traj = TRAJ_LAP + TRAJ_EXTRA
        _check_source_run("trajectory (TUM lap, imu + wheel)", traj, n_traj)
        if traj["launches"]["guess"] < n_traj - 1:
            raise AssertionError(f"sources trajectory: {traj['launches']['guess']} guess "
                                 "launches")
        ls = loc["summary"]
        print("sources: localize --trajectory " + json.dumps(
            {**{k: ls[k] for k in ("queries", "localized", "median_err_m")},
             "launches": loc["launches"]}))
        if ls["localized"] < 1 or not ls["median_err_m"] < 1.5 or loc["launches"]["nn"] < 1:
            raise AssertionError(f"sources localize --trajectory: {ls}")
        paths["sources trajectory"] = traj["launches"]
        paths["sources localize trajectory"] = loc["launches"]

        (wrote,) = _sources_call("write kitti", [{"kind": "write_kitti", "root": tmp}])
        print("sources: kitti files " + json.dumps(wrote))
        if wrote["points_mean"] < 0.8 * KITTI_POINTS:
            raise AssertionError(f"sources: the kitti scans are too sparse: {wrote}")
        kit = {"kind": "run_kitti", "velodyne_dir": wrote["velodyne_dir"], "gt": wrote["gt"],
               "device": "cuda", "out": os.path.join(tmp, "kitti")}
        host_realism, k_defer, k_sync, k_dev, k_bucket = _sources_call("host", [
            {"kind": "run_sim", "scans": REALISM_HOST_SCANS, "radius": RADIUS, "seed": SEED,
             "device": "cuda", "realism": True},
            {**kit, "engine": "host"}, {**kit, "engine": "host", "defer_sync": False},
            {**kit, "engine": "device"},
            {**kit, "engine": "device", "overrides": list(BUCKETED)}])
        bucket = _bucketed_against_exact(wrote["velodyne_dir"], smi)
    _check_source_run("realism host", host_realism, REALISM_HOST_SCANS, loops=False)
    for name, rec in (("run-kitti host defer_sync", k_defer), ("run-kitti host", k_sync),
                      ("run-kitti device", k_dev),
                      ("run-kitti device statistical_bucketed", k_bucket)):
        _check_source_run(name, rec, KITTI_SCANS)
        if rec["summary"]["reader"] != "native":
            raise AssertionError(f"sources {name}: the reader was {rec['summary']['reader']}")
    if k_defer["pose_hash"] != k_sync["pose_hash"]:
        raise AssertionError("sources: defer_sync changed the host engine's poses")
    print(f"sources: run-kitti host scans/s defer_sync {k_defer['summary']['scans_per_sec']} "
          f"against {k_sync['summary']['scans_per_sec']} without, poses identical ({smi})")
    paths.update({"sources realism host": host_realism["launches"],
                  "sources kitti host defer": k_defer["launches"],
                  "sources kitti host": k_sync["launches"],
                  "sources kitti device": k_dev["launches"],
                  "sources kitti device bucketed": k_bucket["launches"]})
    print(f"sources: run-kitti device statistical_bucketed (6 voxels a bucket) "
          f"{k_bucket['summary']['scans_per_sec']} scans/s beside the radius filter's "
          f"{k_dev['summary']['scans_per_sec']} ({smi}); the outlier stage alone, with "
          f"buckets of 4 / 6 voxels, " + " / ".join(
              f"{bucket[m]['bucketed_ms_per_scan']:.3f}" for m in BUCKET_MULTS)
          + f" ms a scan against the exact statistical filter's "
          f"{bucket[BUCKET_MULTS[0]]['exact_ms_per_scan']:.3f}")
    print(f"sources: {time.perf_counter() - t0:.1f} s")
    return {"paths": paths}


# the extras phase (12): the modules the reference runs beside its main
# path, each through the host engine or on the circuit's keyframes
GROUND_D = 1.73          # the simulator's ground lies at z = -1.73 m (utils/sim.py:39-45)
GROUND_COMPARE_SCANS = 16
GROUND_NEAR = 1e-5       # a point this close to a threshold may fall either side
GICP_PAIRS = 16
LOCALMAP_WINDOWS = (20, 50)
TRACE_SCANS = 4
JOB_WAIT_S = 300    # s: a waited-for loop job, the first one building and capturing ICP


def _ground_against_cpu(scans: list, cfg) -> dict:
    """`detect_plane` on the card (enqueued under `set_sync_debug_mode
    ("error")`: no host synchronisation) against the same code on the CPU,
    given the card's triples: the band equal; the candidates equal but where the
    normal lies within GROUND_NEAR of its threshold or the point's k-NN set
    differs (the expanded distance rounds differently on the two devices,
    which decides between nearly equidistant neighbours; counted); then,
    given the card's candidates, `valid` equal, coefficients within TOL, the
    ground mask equal but within GROUND_NEAR of `ransac_thresh`."""
    from xchu_slam_tpu_torch.ops import ground
    from xchu_slam_tpu_torch.ops.filter import filter_scan
    from xchu_slam_tpu_torch.types import make_cloud

    spec = ground.spec_from_config(cfg.ground)
    cos_t = float(torch.cos(torch.deg2rad(torch.tensor(spec.normal_angle_deg))))
    err, near_cand, knn_cand, knn_sets, near_ground = 0.0, 0, 0, 0, 0
    for xyz, inten in scans:
        filt = filter_scan(make_cloud(xyz, inten, capacity=cfg.filter.max_raw_points,
                                      device="cuda"), cfg.filter)
        xyz_c, band_c, nrm_c, cand_c = ground.candidates(filt.xyz, filt.mask, spec)
        tri = ground.draw_triples(cand_c, spec.ransac_iters)
        card = ground.fit_plane(xyz_c, cand_c, tri, spec)
        # the whole detection enqueued with no host synchronisation
        torch.cuda.set_sync_debug_mode("error")
        try:
            whole = ground.detect_plane(filt.xyz, filt.mask, spec)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not all(torch.equal(a, b) for a, b in zip(card, whole)):
            raise AssertionError("ground: detect_plane differs from its own parts")
        xyz_h, band_h, _nrm_h, cand_h = ground.candidates(filt.xyz.cpu(), filt.mask.cpu(), spec)
        if not torch.equal(band_h, band_c.cpu()):
            raise AssertionError("ground: the band differs between the card and the CPU")
        differ = (cand_h != cand_c.cpu()).numpy()
        near = (torch.abs(nrm_c[:, 2].abs() - cos_t) <= GROUND_NEAR).cpu().numpy()
        other_set = (ground.knn_indices(xyz_h, band_h, spec.normal_knn).sort(1).values
                     != ground.knn_indices(xyz_c, band_c, spec.normal_knn).sort(1).values.cpu()
                     ).any(1).numpy()
        if (differ & ~near & ~other_set).any():
            raise AssertionError(f"ground: {int((differ & ~near & ~other_set).sum())} "
                                 "candidates differ away from the normal threshold with the "
                                 "same neighbours")
        near_cand += int((differ & near).sum())
        knn_cand += int((differ & ~near).sum())
        knn_sets += int((other_set & band_c.cpu().numpy()).sum())
        host = ground.fit_plane(xyz_h, cand_c.cpu(), tri.cpu(), spec)
        if bool(host.valid) != bool(card.valid):
            raise AssertionError("ground: valid differs between the card and the CPU")
        err = max(err, float((host.coeffs - card.coeffs.cpu()).abs().max()))
        c = card.coeffs.cpu()
        dist = torch.abs(xyz_h @ c[:3] + c[3])
        gdiff = (host.ground_mask != card.ground_mask.cpu()).numpy()
        if (gdiff & ~(torch.abs(dist - spec.ransac_thresh) <= GROUND_NEAR).numpy()).any():
            raise AssertionError("ground: the ground masks differ away from ransac_thresh")
        near_ground += int(gdiff.sum())
    if not err <= TOL:
        raise AssertionError(f"ground: coefficients differ by {err} between the card and the CPU")
    return {"scans": len(scans), "max_abs_err_coeffs": err,
            "candidates_differing_near_threshold": near_cand,
            "candidates_differing_with_other_knn_set": knn_cand,
            "band_points_with_other_knn_set": knn_sets,
            "ground_points_differing_near_threshold": near_ground}


def _extras_ground(smi: str, main_counts: dict, main_summary: dict):
    """(a) `filter.detect_ground` through the host engine on the circuit.
    Returns (record, launches, pipeline, scan index of each verification)."""
    from xchu_slam_tpu_torch.cli import pose_hash, run_sim, sim_config
    from xchu_slam_tpu_torch.models.pipeline import SlamPipeline
    from xchu_slam_tpu_torch.ops import icp

    events, results, raw, verify_at, scan_no = [], [], [], [], [0]
    maybe_ground, align = SlamPipeline._maybe_ground, icp.align

    def timed_ground(self, filt):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = maybe_ground(self, filt)
        e.record()
        events.append((s, e))
        return out

    def marking_align(*args, **kw):
        verify_at.append(scan_no[0])
        return align(*args, **kw)

    def on_scan(i, res, scan):
        results.append(res["ground"])
        if i < GROUND_COMPARE_SCANS:
            raw.append((scan["xyz"].copy(), scan["intensity"].copy()))
        scan_no[0] = i + 1

    SlamPipeline._maybe_ground, icp.align = timed_ground, marking_align
    try:
        (pipe, summary), counts = _count_launches(lambda: run_sim(
            SCANS, RADIUS, SEED, "cuda", overrides=["filter.detect_ground=true"],
            on_scan=on_scan))
    finally:
        SlamPipeline._maybe_ground, icp.align = maybe_ground, align
    torch.cuda.synchronize()
    valid = torch.stack([g.valid for g in results]).cpu().numpy()
    d = torch.stack([g.coeffs[3] for g in results]).cpu().numpy()
    nz = torch.stack([g.coeffs[2] for g in results]).cpu().numpy()
    ms = float(np.mean([s.elapsed_time(e) for s, e in events]))
    rec = {"card": smi, "scans": len(results), "valid_share": round(float(valid.mean()), 4),
           "median_abs_d_minus_1.73_m": float(np.median(np.abs(d[valid] - GROUND_D))),
           "min_normal_z_valid": float(nz[valid].min()),
           "ground_ms_per_scan": round(ms, 5), "scans_per_sec": summary["scans_per_sec"],
           "main_scans_per_sec": main_summary["scans_per_sec"],
           "pose_hash": pose_hash(pipe), "main_pose_hash": main_summary["pose_hash"],
           "keyframes": summary["keyframes"], "loops": summary["loops"],
           "ate_rmse_m": summary["ate_rmse_m"],
           "nn_launches": counts["nn"], "ndt_launches": counts["ndt"]}
    rec["card_against_cpu"] = _ground_against_cpu(raw, sim_config())
    print(f"extras ground [{smi}]: " + json.dumps(rec))
    if len(results) != SCANS or not valid.mean() > 0.5:
        raise AssertionError(f"ground: a valid plane on {valid.mean():.3f} of the scans")
    if not rec["median_abs_d_minus_1.73_m"] < 0.05:
        raise AssertionError(f"ground: median |d - 1.73| {rec['median_abs_d_minus_1.73_m']} m")
    if rec["pose_hash"] != rec["main_pose_hash"]:
        raise AssertionError("ground: the poses differ from the main path's")
    if counts["nn"] != main_counts["nn"] or counts["ndt"] != main_counts["ndt"]:
        raise AssertionError(f"ground: NN / NDT launches {counts['nn']} / {counts['ndt']} "
                             f"against main's {main_counts['nn']} / {main_counts['ndt']}")
    return rec, counts, pipe, verify_at


def _trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace, counted by the port's kernel names."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {tag: sum(tag in n for n in names) for tag in
             ("ndt_align_kernel", "nn_kernel", "nn_merge_kernel", "icp_step_kernel")}
    return {"kernel_events": len(names), **found}


def _extras_async(smi: str, main_counts: dict, main_summary: dict, verify_at: list):
    """(b) `loop.async_detect` on the circuit: free-running, then with each
    job waited for (poses equal to the main path's), and (e) inside that run
    a `device_trace` over the TRACE_SCANS scans around the first
    verification."""
    from xchu_slam_tpu_torch.cli import pose_hash, run_sim
    from xchu_slam_tpu_torch.models.async_worker import AsyncLoopWorker
    from xchu_slam_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    (pipe, summary), free = _count_launches(lambda: run_sim(
        SCANS, RADIUS, SEED, "cuda", overrides=["loop.async_detect=true"]))
    _check_loop_kernels("extras async", free, pipe.icp_verifications, summary["loops"],
                        _inloop_gn(pipe))
    rec = {"card": smi, "free_running": {
        "keyframes": summary["keyframes"], "loops": summary["loops"],
        "ate_rmse_m": summary["ate_rmse_m"], "verifications": pipe.icp_verifications,
        "scans_per_sec": summary["scans_per_sec"],
        "sync_scans_per_sec": main_summary["scans_per_sec"]}}
    if summary["loops"] < 1 or not summary["ate_rmse_m"] < 1.0:
        raise AssertionError(f"async free-running: {rec['free_running']}")
    del pipe

    first = verify_at[0]
    start = max(first - 2, 1)        # the traced scans: start .. start + TRACE_SCANS - 1
    stack, trace_dir = [], tempfile.mkdtemp(prefix="extras_trace_")

    def on_scan(i, _res, _scan):
        if i == start - 1:
            stack.append(device_trace(trace_dir))
            stack[0].__enter__()
        elif i == start + TRACE_SCANS - 1:
            stack.pop().__exit__(None, None, None)

    submit = AsyncLoopWorker.submit

    def submit_and_wait(self, k, stamp):
        submit(self, k, stamp)
        with self.jobs.all_tasks_done:
            if not self.jobs.all_tasks_done.wait_for(lambda: not self.jobs.unfinished_tasks,
                                                     JOB_WAIT_S):
                raise AssertionError(f"async, waiting: the loop worker's job for keyframe "
                                     f"{k} did not finish within {JOB_WAIT_S} s")

    AsyncLoopWorker.submit = submit_and_wait
    try:
        (pipe, summary), waiting = _count_launches(lambda: run_sim(
            SCANS, RADIUS, SEED, "cuda", overrides=["loop.async_detect=true"],
            on_scan=on_scan))
    finally:
        AsyncLoopWorker.submit = submit
        while stack:
            stack.pop().__exit__(None, None, None)
    path = os.path.join(trace_dir, TRACE_FILE)
    rec["waiting"] = {"loops": summary["loops"], "ate_rmse_m": summary["ate_rmse_m"],
                      "pose_hash": pose_hash(pipe), "main_pose_hash": main_summary["pose_hash"],
                      "nn_launches": waiting["nn"], "main_nn_launches": main_counts["nn"]}
    trace = {"scans": list(range(start, start + TRACE_SCANS)), "first_verification": first,
             "bytes": os.path.getsize(path), **_trace_kernels(path)}
    print(f"extras async [{smi}]: " + json.dumps(rec))
    print(f"extras trace [{smi}]: " + json.dumps(trace))
    if rec["waiting"]["pose_hash"] != rec["waiting"]["main_pose_hash"]:
        raise AssertionError("async, each job waited for: the poses differ from the main path's")
    if trace["ndt_align_kernel"] < 1 or trace["nn_kernel"] < 1:
        raise AssertionError(f"the trace does not name the NDT and NN kernels: {trace}")
    os.remove(path)
    return free, waiting


def _extras_gicp(smi: str, pipe, gspec) -> dict:
    """(c) GICP between consecutive keyframe clouds of the circuit (4096
    points each; the target the earlier keyframe's grid in its own frame,
    the guess the odometric relative pose) on the card against the CPU."""
    from xchu_slam_tpu_torch.ops import gicp, voxel_map as vm
    from xchu_slam_tpu_torch.utils import se3

    db = pipe.db
    same, err, iters, ms = 0, 0.0, [], []
    for k in range(GICP_PAIRS):
        def inputs(dev):
            tgt = db.clouds[k].to(dev)
            grid = vm.make_grid(gspec, vm.centered_origin(gspec, tgt.new_zeros(3)))
            grid = vm.finalize(vm.insert_points(grid, tgt, db.cloud_mask[k].to(dev), gspec), gspec)
            rel = torch.matmul(se3.inverse(se3.pose_to_matrix(db.poses[k])),
                               se3.pose_to_matrix(db.poses[k + 1]))
            return (db.clouds[k + 1].to(dev), db.cloud_mask[k + 1].to(dev), grid,
                    se3.matrix_to_pose(rel).to(dev), gspec)

        args = inputs("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = gicp.align(*args)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        host = gicp.align(*inputs("cpu"))
        iters.append(int(card.iterations))
        if int(host.iterations) == int(card.iterations):
            same += 1
            err = max(err, float((host.pose - card.pose.cpu()).abs().max()))
    rec = {"card": smi, "pairs": GICP_PAIRS, "points": int(db.clouds.shape[1]),
           "same_iterations": same, "max_abs_err_pose": err,
           "iterations": iters, "ms_per_align_first": round(ms[0], 3),
           "ms_per_align_median": round(float(np.median(ms[1:])), 3)}
    print(f"extras gicp [{smi}]: " + json.dumps(rec))
    if same < 0.9 * GICP_PAIRS or not err <= TOL:
        raise AssertionError(f"gicp on the card against the CPU: {rec}")
    return rec


LOCALMAP_MEAN_TOL = 1e-4   # m: the transform's last bit at 50 m moves a voxel mean ~4e-6 m
# A voxel's sums are of voxel-local offsets in [0, resolution), so a first
# moment is bounded by n·res and a second by n·res². Each moment column is held
# to the CPU's within STATS_RTOL of that bound: the transform's last bit at
# 60 m (~8e-6 m) and a float32 sum's rounding stay below 3e-5 of it.
STATS_RTOL = 1e-4
# the trigonometric eigenvalues are within 2e-4 of the largest of float64's
# (tests/test_torch_foundations.py); the inverse covariance sees eigenvalues
# down to eig_inflation of the largest, so its rows are held to float64's
# within 2e-4 / eig_inflation of the row's largest entry
EIG_F64_RTOL = 2e-4


def _localmap_errors(card, host, gspec) -> dict:
    """A grid built on the card against the same build on the CPU: the
    voxels whose point count or validity differs; each moment column's
    largest |Δ| card against CPU relative to its bound (STATS_RTOL); on the
    voxels valid in both, the largest |Δ mean| and |Δ inverse covariance|
    relative to the voxel's largest entry, card against CPU, and the card's
    against a float64 finalize of its own sums (near-repeated eigenvalues
    make the float32 inverse covariance of a thin voxel uncertain to ~1 %,
    on either device, so the inverse covariance is held to float64 and the
    sums card to CPU)."""
    from xchu_slam_tpu_torch.ops import voxel_map as vm

    c, h = card.fin.cpu(), host.fin
    cs, hs = card.stats.cpu(), host.stats
    both = (c[:, 9] > 0) & (h[:, 9] > 0)
    n = torch.clamp(hs[:, :1], min=1.0)
    res = gspec.resolution
    bound = torch.cat([n.expand(-1, 3) * res, n.expand(-1, 6) * res * res], 1)
    stats_rel = ((cs[:, 1:] - hs[:, 1:]).abs() / bound).max(0).values

    def icov_rel(a, ref):
        scale = ref[both, 3:9].abs().max(1, keepdim=True).values + 1e-30
        return float(((a[both, 3:9] - ref[both, 3:9]).abs() / scale).max())

    return {"points": int(cs[:, 0].sum()), "valid_voxels": int(both.sum()),
            "voxels_other_count": int((cs[:, 0] != hs[:, 0]).sum()),
            "voxels_other_validity": int((c[:, 9] != h[:, 9]).sum()),
            "max_rel_err_stats_by_column": [float(x) for x in stats_rel],
            "max_abs_err_mean_m": float((c[both, :3] - h[both, :3]).abs().max()),
            "max_rel_err_icov_card_cpu": icov_rel(c, h),
            "max_rel_err_icov_card_f64": icov_rel(c, vm.finalize_stats(cs.double(), gspec))}


def _extras_localmaps(smi: str, pipe, gspec) -> dict:
    """(d) The window and distance localmaps from the circuit's last
    keyframes on the card against the CPU (`_localmap_errors`: the counts
    and validity equal, every moment column within STATS_RTOL of its bound,
    means within LOCALMAP_MEAN_TOL, the card's inverse covariance within
    EIG_F64_RTOL / eig_inflation of a float64 finalize of its sums); ms a
    build from CUDA events."""
    from xchu_slam_tpu_torch.models import localmap_keyframes as lk

    db = pipe.db
    n = pipe.kf_count
    rec = {"card": smi, "keyframes": n, "points_per_keyframe": int(db.clouds.shape[1])}
    for w in LOCALMAP_WINDOWS:
        for name, build, kw in (("window", lk.build_window_localmap, {"window": w}),
                                ("distance", lk.build_distance_localmap,
                                 {"radius": 50.0, "max_window": w})):
            def run(dev):
                centre = db.opt_poses[n - 1, :3].to(dev)
                return build(db.clouds.to(dev), db.cloud_mask.to(dev), db.opt_poses.to(dev),
                             n, centre, gspec, **kw)

            card = run("cuda")
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                run("cuda")
            e.record()
            torch.cuda.synchronize()
            host = run("cpu")
            rec[f"{name} {w}"] = {**_localmap_errors(card, host, gspec),
                                  "host_points": int(host.stats[:, 0].sum()),
                                  "ms": round(s.elapsed_time(e) / 5, 4)}
    print(f"extras localmaps [{smi}]: " + json.dumps(rec))
    for key, row in rec.items():
        if isinstance(row, dict) and (
                row["points"] != row["host_points"] or row["points"] == 0
                or row["voxels_other_count"] or row["voxels_other_validity"]
                or not max(row["max_rel_err_stats_by_column"]) <= STATS_RTOL
                or not row["max_abs_err_mean_m"] <= LOCALMAP_MEAN_TOL
                or not row["max_rel_err_icov_card_f64"] <= EIG_F64_RTOL / gspec.eig_inflation):
            raise AssertionError(f"localmap {key} on the card against the CPU: {row}")
    return rec


def phase_extras(smi: str, main_counts: dict, main_summary: dict) -> dict:
    """Phase 12: ground, the async worker, GICP, the localmaps and a device
    trace. Returns the launches of its paths."""
    from xchu_slam_tpu_torch.cli import sim_config
    from xchu_slam_tpu_torch.ops import voxel_map as vm

    t0 = time.perf_counter()
    _rec, ground_counts, pipe, verify_at = _extras_ground(smi, main_counts, main_summary)
    free, waiting = _extras_async(smi, main_counts, main_summary, verify_at)
    gspec = vm.spec_from_config(sim_config().ndt)
    _rec, gicp_counts = _count_launches(lambda: _extras_gicp(smi, pipe, gspec))
    _rec, map_counts = _count_launches(lambda: _extras_localmaps(smi, pipe, gspec))
    print(f"extras: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"paths": {"extras ground": ground_counts, "extras async": free,
                      "extras async waiting + trace": waiting, "extras gicp": gicp_counts,
                      "extras localmaps": map_counts}}


# ---- the mesh phase: the sharded ops on rank groups ---- #

MESH_ALIGNS = 64          # the circuit's first aligns, replayed on every group
MESH_SUPERSTEPS = 8       # slam_superstep on the first scans of those
MESH_SAME_ITERS = 0.9     # share of aligns with the single-device kernel's Newton count
MESH_GROUP_TIMEOUT = 300  # s, a group's whole run, interpreters started to results read
MESH_KERNELS = ("nn", "ndt_pass", "icp_partial", "icp_solve", "pgo")
# the kernels line's other keys of a path, counted in the mesh groups too
MESH_PATH_KEYS = ("ndt", "icp_step", "guess", "icp_live_trips")
# the (backend, ranks) of the groups on one card: several ranks share it over
# gloo (each collective staged through pinned host memory), NCCL puts one
# rank on a card
MESH_GROUPS = (("gloo", 2), ("gloo", 4), ("nccl", 1))
NDT_PASS_FLOP = {"hessian": 0, "gradient": 1, "fitness": 2}   # index into ndt_flop
# bytes a point and FP32 operations a point of the ICP split's entries: stage
# 0 reads the point, mask, index, d² and the gathered target (the sums'
# 8 multiply-adds), stage 1 the same (the 9 centred products, 3 + 9
# multiply-adds), solve reads the point and writes the transformed one (9
# multiply-adds); the eigen-solve is one per launch
ICP_SPLIT_BYTES_PT = {"partial0": 12 + 1 + 4 + 4 + 12, "partial1": 12 + 1 + 4 + 4 + 12,
                      "solve": 12 + 12}
ICP_SPLIT_FLOP_PT = {"partial0": 2 * 8 + 15, "partial1": 2 * 12 + 15, "solve": 2 * 9}


def _mesh_counts() -> dict:
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                             pgo_kernel)
    from xchu_slam_tpu_torch.utils import collectives

    return {"nn": nn_kernel.launches, "ndt": ndt_kernel.launches,
            "ndt_pass": ndt_kernel.pass_launches, "icp_step": icp_kernel.launches,
            "icp_partial": icp_kernel.partial_launches,
            "icp_solve": icp_kernel.solve_launches, "pgo": pgo_kernel.launches,
            "guess": guess_kernel.launches, "icp_live_trips": icp.live_trip_count(),
            "collectives": collectives.collectives, "host_staged": collectives.host_staged}


def _mesh_reset() -> None:
    from xchu_slam_tpu_torch.ops import icp
    from xchu_slam_tpu_torch.ops.cuda import (guess_kernel, icp_kernel, ndt_kernel, nn_kernel,
                                             pgo_kernel)
    from xchu_slam_tpu_torch.utils import collectives

    nn_kernel.launches = ndt_kernel.launches = ndt_kernel.pass_launches = 0
    pgo_kernel.launches = icp_kernel.launches = guess_kernel.launches = 0
    icp_kernel.partial_launches = icp_kernel.solve_launches = 0
    icp.live_trips.clear()
    collectives.collectives = collectives.host_staged = 0


def mesh_rank(mesh, path: str) -> dict:
    """One rank of a mesh group (`parallel/distributed.launch` runs it in a
    fresh interpreter): the saved inputs through every sharded op on this
    rank's device. Per op: the results, ms a call from CUDA events (after
    one warm-up call), and the kernel launches and collectives of the timed
    calls, counted from 0."""
    from xchu_slam_tpu_torch.models import pose_graph as pg
    from xchu_slam_tpu_torch.ops import icp, ndt, scancontext as sc, voxel_map as vm
    from xchu_slam_tpu_torch.parallel import sharded
    from xchu_slam_tpu_torch.types import VoxelGrid

    inp = torch.load(path, weights_only=False)
    dev = mesh.device
    out = {"results": {}, "ms": {}, "launches": {}, "device": str(dev)}

    def to(x):
        return tuple(to(a) for a in x) if isinstance(x, tuple) else x.to(dev)

    def run(name, calls):
        if not calls:
            out["launches"][name], out["ms"][name] = _mesh_counts(), None
            return []
        calls[0]()                                 # libraries loaded, first-call set-up
        torch.cuda.synchronize(dev)
        _mesh_reset()
        ms, res = 0.0, []
        for fn in calls:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res.append(fn())
            b.record()
            b.synchronize()
            ms += a.elapsed_time(b)
        out["launches"][name] = _mesh_counts()
        out["ms"][name] = ms / len(calls)
        return res

    n = inp["ndt"]
    gspec, nspec = vm.GridSpec(*n["gspec"]), ndt.NdtSpec(*n["nspec"])
    aligns = [(VoxelGrid(origin=to(o), stats=None, fin=to(f)), to(x), to(m), to(g))
              for f, o, x, m, g in n["cases"]]

    def ndt_call(a):
        r = ndt.align(*a, gspec, nspec, mesh=mesh)
        return r.pose.cpu().numpy(), int(r.iterations)

    out["results"]["ndt"] = run("ndt", [lambda a=a: ndt_call(a) for a in aligns])

    s = inp["sc"]
    scspec, db = sc.ScSpec(*s["spec"]), to(s["db"])

    def sc_call(q, count, cur):
        c = sc.read_candidate(sc.detect_loop_on_device(q, db, count, scspec, cur, mesh=mesh))
        return c.idx, c.found, c.dist

    out["results"]["sc"] = run("sc", [lambda q=to(q), c=c, k=k: sc_call(q, c, k)
                                      for q, c, k in s["cases"]])

    c = inp["icp"]
    ispec = icp.IcpSpec(*c["spec"])

    def icp_call(args):
        r = icp.align(*args, ispec, mesh=mesh)
        return (r.T.cpu().numpy(), int(r.iterations), bool(r.converged),
                float(r.fitness))

    out["results"]["icp"] = run("icp", [lambda a=to(a): icp_call(a) for a in c["cases"]])

    p = inp["pgo"]
    pgspec = pg.GraphSpec(*p["spec"])
    graphs = [(to(poses), pg.GraphData(*to(graph))) for poses, graph in p["cases"]]
    out["results"]["pgo"] = [
        run(f"pgo {name}", [lambda g=g: pg.solve(g[0], g[1], pgspec, mesh=mesh).cpu().numpy()])[0]
        for name, g in zip(p["names"], graphs)]

    u = inp["superstep"]
    uspec = sc.ScSpec(*u["spec"])

    def superstep(a):
        pose, iters, desc, cand, opt = sharded.slam_superstep(
            mesh, *a, gspec, nspec, db, u["count"], uspec, *graphs[0], pgspec)
        return (pose.cpu().numpy(), int(iters), desc.cpu().numpy(), cand.cpu().numpy(),
                opt.cpu().numpy())

    out["results"]["superstep"] = run("superstep", [lambda a=a: superstep(a)
                                                    for a in aligns[:MESH_SUPERSTEPS]])
    return out


def _split_icp_against_step(src, smask, tgt, tmask, init, spec) -> int:
    """`icp_partial` + `icp_solve` against `icp_step` on the same state, trip
    by trip: state and transformed source bit-identical (a mesh of one rank
    runs the split). Returns the trips."""
    from xchu_slam_tpu_torch.ops.cuda import icp_kernel, nn_kernel

    dev = src.device
    max_d2 = spec.max_corr_dist ** 2
    live = torch.ones((), dtype=torch.bool, device=dev)
    st_a, st_b = (torch.zeros(icp_kernel.STATE_FLOATS, device=dev) for _ in range(2))
    cur_a, cur_b = torch.empty_like(src), torch.empty_like(src)
    icp_kernel.init(src, init, live, st_a, cur_a)
    icp_kernel.init(src, init, live, st_b, cur_b)
    trips = 0
    while float(st_a[icp_kernel.STATE["live"]]) > 0.5:
        idx, d2 = nn_kernel.nearest_neighbor(cur_a, tgt, tmask)
        icp_kernel.step(src, smask, tgt, idx, d2, cur_a, st_a, max_d2, spec.trans_eps,
                        spec.max_iterations)
        s8 = icp_kernel.partial(src, smask, tgt, idx, d2, st_b, max_d2, 0)
        s9 = icp_kernel.partial(src, smask, tgt, idx, d2, st_b, max_d2, 1, s8)
        icp_kernel.solve(src, torch.cat([s8, s9]), st_b, cur_b, spec.trans_eps,
                         spec.max_iterations)
        if not (torch.equal(st_a, st_b) and torch.equal(cur_a, cur_b)):
            raise AssertionError(f"mesh: icp_partial + icp_solve differ from icp_step at "
                                 f"trip {trips}: {st_a.cpu().numpy()} against "
                                 f"{st_b.cpu().numpy()}")
        trips += 1
    return trips


def _mesh_entry_points(smi: str, rec: dict) -> dict:
    """The new entry points against their plain versions at the shards'
    shapes (D = 2 and 4 of the circuit's first align and first
    verification), their times from CUDA-graph replays beside their bounds
    and their plain versions' times, the split ICP step against icp_step bit
    for bit, and the NN kernel's time and split at the shard's shapes."""
    from xchu_slam_tpu_torch.ops import icp, ndt, ndt_deriv, voxel_map as vm
    from xchu_slam_tpu_torch.ops.cuda import icp_kernel, ndt_kernel, nn_kernel
    from xchu_slam_tpu_torch.types import VoxelGrid

    out = {}
    (fin, origin, xyz, mask, guess, gspec, nspec), _res = rec["aligns"][0]
    grid = VoxelGrid(origin=origin, stats=None, fin=fin)
    d1, d2 = ndt.gauss_constants(nspec.outlier_ratio, nspec.resolution)
    trial = guess + torch.tensor([0.03, -0.02, 0.01, 0.002, 0.001, -0.004], device=guess.device)
    m = vm.NEIGHBOR_COUNT[nspec.neighbor_mode]
    err, rows = 0.0, {}
    for D in (2, 4):
        n = xyz.shape[0] // D
        x, k = xyz[:n].contiguous(), mask[:n].contiguous()
        for ctx, pose in ((guess, guess), (guess, trial)):
            nb = ndt_deriv.neighborhood(ctx, x, grid, gspec, nspec.neighbor_mode)
            Lp, gp, Hp = ndt_deriv.ndt_value_grad_hess(pose, x, k, grid, gspec, d1, d2, nb=nb)
            fit_p = torch.stack([t.to(torch.float32)
                                 for t in ndt._fitness_sums(pose, x, k, nb)])
            h = ndt_kernel.shard_pass(fin, origin, x, k, pose, ctx, gspec, nspec, d1, d2,
                                      "hessian")
            f = ndt_kernel.shard_pass(fin, origin, x, k, pose, ctx, gspec, nspec, d1, d2,
                                      "fitness")
            got = torch.cat([h[:1], -d2 * h[1:7], ndt._upper6(h[7:28]).reshape(36)])
            want = torch.cat([Lp.reshape(1), gp, Hp.reshape(36)])
            e = float((got - want).abs().max() / want.abs().max())
            fe = float(((f[28:31] - fit_p).abs() / fit_p.abs().clamp(min=1)).max())
            if not e <= NDT_PASS_TOL or not fe <= NDT_PASS_TOL:
                raise AssertionError(f"ndt shard pass at {n} points: (L, g, H) off by {e:.3g} "
                                     f"of the largest entry, fitness sums by {fe:.3g} (> "
                                     f"{NDT_PASS_TOL})")
            err = max(err, e, fe)
        for kind in ("hessian", "gradient", "fitness"):
            ms = _graph_ms(lambda: ndt_kernel.shard_pass(fin, origin, x, k, trial, guess, gspec,
                                                         nspec, d1, d2, kind), calls=20)
            flop = n * ndt_flop(m)[NDT_PASS_FLOP[kind]]
            bytes_ms = 1e3 * (n * 12 + n + n * m * 40 + 24 * 4 + 32 * 4) / HBM_BYTES_PER_S
            ops_ms = 1e3 * flop / FP32_FLOPS
            rows[(D, kind)] = (ms, max(bytes_ms, ops_ms),
                               "bytes" if bytes_ms > ops_ms else "operations")
        plain_ms = _host_ms(lambda: ndt_deriv.ndt_value_grad_hess(
            trial, x, k, grid, gspec, d1, d2,
            nb=ndt_deriv.neighborhood(guess, x, grid, gspec, nspec.neighbor_mode)))
        rows[(D, "plain")] = plain_ms
        blocks, trips = ndt_kernel.plan(n, ndt_kernel.pass_max_blocks(0, nspec.neighbor_mode),
                                        ndt_kernel.LANES[nspec.neighbor_mode])
        print(f"mesh [{smi}]: ndt shard pass at {n} points (D = {D}; {blocks} blocks, "
              f"{trips} trip): hessian {rows[(D, 'hessian')][0]:.5f} ms (bound "
              f"{rows[(D, 'hessian')][1]:.6f} ms by {rows[(D, 'hessian')][2]}), gradient "
              f"{rows[(D, 'gradient')][0]:.5f} ms, fitness {rows[(D, 'fitness')][0]:.5f} ms "
              f"a launch from CUDA-graph replays; the plain Hessian pass {plain_ms:.3f} ms on "
              f"the host's clock")
    hb = rows[(4, "hessian")]
    out["ndt_shard_pass"] = {"max_abs_err": err, "ms": hb[0], "plain_ms": rows[(4, "plain")],
                             "bound_ms": hb[1], "bound_by": hb[2], "library_ms": None,
                             "shape": [xyz.shape[0] // 4, m],
                             "ms_by_kind_and_shard": {f"{kind} D={D}": rows[(D, kind)][0]
                                                      for D in (2, 4) for kind in
                                                      ("hessian", "gradient", "fitness")}}

    (src, smask, tgt, tmask, init, spec), res = rec["verifications"][0]
    trips = _split_icp_against_step(src, smask, tgt, tmask, init.to(torch.float32), spec)
    print(f"mesh: icp_partial + icp_solve reproduce icp_step bit for bit over the first "
          f"verification's {trips} trips (a mesh of one rank)")
    max_d2 = spec.max_corr_dist ** 2
    icp_rows, icp_err = {}, 0.0

    def plain_sums(cur, k, idx, d2, s8=None):
        """The shard's sums by PyTorch: `icp._moments`' passes before their
        division, the second about the means of `s8` (its own first if None)."""
        w = (k & (d2 < max_d2)).to(torch.float32)
        nn = tgt[idx]
        p8 = torch.cat([w.sum()[None], (cur * w[:, None]).sum(0), (nn * w[:, None]).sum(0),
                        (d2 * w).sum()[None]])
        s8 = p8 if s8 is None else s8
        wsum = torch.clamp(s8[0], min=1.0)
        p9 = ((nn - s8[4:7] / wsum).T @ ((cur - s8[1:4] / wsum) * w[:, None])).reshape(9)
        return p8, p9

    def plain_update(hs, st):
        """T after the host's update from the 17 sums `hs` (align_ref's)."""
        wsum = torch.clamp(hs[0], min=1.0)
        R = icp.kabsch_ref(hs[8:17].reshape(3, 3) / wsum)
        dT = torch.eye(4)
        dT[:3, :3], dT[:3, 3] = R, hs[4:7] / wsum - R @ (hs[1:4] / wsum)
        return dT @ st[:16].reshape(4, 4).cpu()

    for D in (2, 4):
        n = src.shape[0] // D
        s, k = src[:n].contiguous(), smask[:n].contiguous()
        st = torch.zeros(icp_kernel.STATE_FLOATS, device=src.device)
        cur = torch.empty_like(s)
        icp_kernel.init(s, init.to(torch.float32).contiguous(),
                        torch.ones((), dtype=torch.bool, device=src.device), st, cur)
        idx, d2 = nn_kernel.nearest_neighbor(cur, tgt, tmask)
        s8 = icp_kernel.partial(s, k, tgt, idx, d2, st, max_d2, 0)
        s9 = icp_kernel.partial(s, k, tgt, idx, d2, st, max_d2, 1, s8)
        p8, p9 = plain_sums(cur, k, idx, d2, s8)
        e = max(float(((s8 - p8).abs() / p8.abs().clamp(min=1)).max()),
                float((s9 - p9).abs().max() / p9.abs().max()))
        # the solve against the plain host update from the same 17 sums
        sums = torch.cat([s8, s9])
        st_s = st.clone()
        icp_kernel.solve(s, sums, st_s, cur, spec.trans_eps, spec.max_iterations)
        hs = sums.cpu()
        T_want = plain_update(hs, st)
        T_got = st_s[:16].reshape(4, 4).cpu()
        e_solve = max(float((T_got[:3, :3] - T_want[:3, :3]).abs().max()),
                      float((T_got[:3, 3] - T_want[:3, 3]).abs().max()) / _lever(s, k))
        if not e <= ICP_TOL or not e_solve <= ICP_TOL:
            raise AssertionError(f"icp split at {n} points: sums off by {e:.3g}, solve by "
                                 f"{e_solve:.3g} (> {ICP_TOL})")
        icp_err = max(icp_err, e, e_solve)
        for name, fn in (("partial0", lambda: icp_kernel.partial(s, k, tgt, idx, d2, st,
                                                                   max_d2, 0)),
                         ("partial1", lambda: icp_kernel.partial(s, k, tgt, idx, d2, st,
                                                                   max_d2, 1, s8)),
                         ("solve", lambda: icp_kernel.solve(s, sums, st_s.clone(), cur.clone(),
                                                            spec.trans_eps,
                                                            spec.max_iterations))):
            ms = _graph_ms(fn, calls=50)
            bytes_ms = 1e3 * (n * ICP_SPLIT_BYTES_PT[name] + 4 * 17) / HBM_BYTES_PER_S
            ops_ms = 1e3 * n * ICP_SPLIT_FLOP_PT[name] / FP32_FLOPS
            icp_rows[(D, name)] = (ms, max(bytes_ms, ops_ms),
                                   "bytes" if bytes_ms > ops_ms else "operations")
        icp_rows[(D, "plain")] = _host_ms(lambda: plain_sums(cur, k, idx, d2))
        icp_rows[(D, "plain_solve")] = _host_ms(lambda: plain_update(hs, st))
        nn_ms = _graph_ms(lambda: nn_kernel.nearest_neighbor(cur, tgt, tmask), calls=50)
        tiles, slices, sub_len = nn_kernel.plan(n, tgt.shape[0], nn_kernel._sm_count(0))
        icp_rows[(D, "nn")] = nn_ms
        print(f"mesh [{smi}]: at a shard of {n} of the verification's points (D = {D}): "
              f"icp_partial stage 0 {icp_rows[(D, 'partial0')][0]:.5f} ms, stage 1 "
              f"{icp_rows[(D, 'partial1')][0]:.5f} ms, icp_solve "
              f"{icp_rows[(D, 'solve')][0]:.5f} ms a launch (bounds "
              f"{icp_rows[(D, 'partial0')][1]:.6f} / {icp_rows[(D, 'partial1')][1]:.6f} / "
              f"{icp_rows[(D, 'solve')][1]:.6f} ms); the plain moments "
              f"{icp_rows[(D, 'plain')]:.3f} ms on the host's clock; the NN kernel "
              f"{nn_ms:.5f} ms at {n} x {tgt.shape[0]} ({tiles} source tiles x {slices} "
              f"slices of {sub_len} targets a warp: {tiles * slices} blocks)")
    p0, p1, sv = (icp_rows[(4, k)] for k in ("partial0", "partial1", "solve"))
    out["icp_partial"] = {"max_abs_err": icp_err, "ms": p0[0] + p1[0],
                          "plain_ms": icp_rows[(4, "plain")], "bound_ms": p0[1] + p1[1],
                          "bound_by": p0[2], "library_ms": None,
                          "stage_ms": {f"{st} D={D}": icp_rows[(D, st)][0] for D in (2, 4)
                                       for st in ("partial0", "partial1")},
                          "shape": [src.shape[0] // 4, tgt.shape[0]]}
    out["icp_solve"] = {"max_abs_err": icp_err, "ms": sv[0],
                        "plain_ms": icp_rows[(4, "plain_solve")],
                        "bound_ms": sv[1], "bound_by": sv[2], "library_ms": None,
                        "ms_by_shard": {f"D={D}": icp_rows[(D, 'solve')][0] for D in (2, 4)},
                        "split_trips_bit_equal": trips}
    out["nn_shard_ms"] = {f"{src.shape[0] // D}x{tgt.shape[0]}": icp_rows[(D, "nn")]
                          for D in (2, 4)}
    return out


def _mesh_inputs(rec: dict, path: str) -> dict:
    """Save what every group replays (CPU tensors, one file) and return the
    parent's single-device results on the card to hold the groups to."""
    import pgo_cases
    from xchu_slam_tpu_torch.models import pose_graph as pg
    from xchu_slam_tpu_torch.ops import scancontext as sc

    cpu = lambda t: t.detach().cpu()   # noqa: E731
    pipe = rec["pipe"]
    aligns = rec["aligns"]
    gspec, nspec = aligns[0][0][5], aligns[0][0][6]
    db, count = pipe.db.sc_db, pipe.db.count
    scspec = rec["queries"][0][0][3]
    if db.shape[0] != pipe.graph.kf_mask.shape[0]:
        raise AssertionError("the descriptor database and the graph differ in capacity")
    icpspec = pipe.icpspec
    pgspec = pg.inloop_spec(pipe.gspec)
    dev = db.device
    # the circuit's final graph (its keyframes' odometry poses, every loop) and
    # phase 4b's capacity graph
    K = pipe.graph.kf_mask.shape[0]
    poses_circuit = pipe.db.poses.clone()
    p2048, g2048 = pgo_cases.chain_graph(K=K, L=pipe.graph.loop_i.shape[0], n_live=K,
                                         n_loops=40, gps=True)
    graphs = [("circuit", poses_circuit, pipe.graph),
              ("capacity", torch.from_numpy(p2048).to(dev), pgo_cases.to_device(g2048, dev))]
    want_pgo = [pg.solve(p, g, pgspec) for _n, p, g in graphs]
    steps = []
    for (fin, origin, xyz, mask, guess, _g, _n), res in aligns[:MESH_SUPERSTEPS]:
        desc = sc.make_descriptor(xyz, mask, scspec)
        eligible = torch.arange(db.shape[0], device=dev) < count - scspec.num_exclude_recent
        dist, _shift = sc.distance_all_rotations(desc, db, eligible, scspec)
        best = int(torch.argmin(dist))
        steps.append((desc.cpu().numpy(), best, float(dist[best])))
    torch.save({
        "ndt": {"gspec": tuple(gspec), "nspec": tuple(nspec),
                "cases": [tuple(cpu(t) for t in a[:5]) for a, _r in aligns]},
        "sc": {"spec": tuple(scspec), "db": cpu(db),
               "cases": [(cpu(q), c, k) for (q, c, k, _s), _r in rec["queries"]]},
        "icp": {"spec": tuple(icpspec),
                "cases": [tuple(cpu(t) for t in a[:5]) for a, _r in rec["verifications"]]},
        "pgo": {"spec": tuple(pgspec), "names": [n for n, _p, _g in graphs],
                "cases": [(cpu(p), tuple(cpu(t) for t in g)) for _n, p, g in graphs]},
        "superstep": {"spec": tuple(scspec), "count": count},
    }, path)
    torch.cuda.synchronize()
    return {"ndt": [(r.pose.cpu().numpy(), int(r.iterations)) for _a, r in aligns],
            "sc": [sc.read_candidate(r) for _a, r in rec["queries"]],
            "icp": [(a, r) for a, r in rec["verifications"]],
            "pgo": {n: w.cpu().numpy() for (n, _p, _g), w in zip(graphs, want_pgo)},
            "superstep": steps}


def _check_group(name: str, ranks: list, want: dict) -> dict:
    """A group's results against each other (bit for bit) and against the
    parent's single-device results; returns the group's printed record."""
    r0 = ranks[0]["results"]
    for r, rk in enumerate(ranks[1:], 1):
        for op, res in rk["results"].items():
            for a, b in zip(res, r0[op]):
                if not all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(a if isinstance(a, tuple) else (a,),
                                           b if isinstance(b, tuple) else (b,))):
                    raise AssertionError(f"mesh {name}: rank {r}'s {op} differs from rank 0's")
    one_rank = len(ranks) == 1
    # NDT: phase 4's rule against the single-device kernel's aligns
    same, dpose = 0, 0.0
    for (pose, it), (wpose, wit) in zip(r0["ndt"], want["ndt"]):
        same += it == wit
        dpose = max(dpose, float(np.abs(pose - wpose).max()))
    if dpose > NDT_POSE_TOL or same < MESH_SAME_ITERS * len(want["ndt"]):
        raise AssertionError(f"mesh {name}: ndt |Δpose| {dpose:.3g} (> {NDT_POSE_TOL}?), the "
                             f"same iteration count on {same} of {len(want['ndt'])}")
    # Scan Context: the same candidate at every keyframe
    for k, ((idx, found, dist), w) in enumerate(zip(r0["sc"], want["sc"])):
        if idx != w.idx or found != w.found:
            raise AssertionError(f"mesh {name}: sc query {k}: ({idx}, {found}) against "
                                 f"({w.idx}, {w.found})")
    # ICP: the same trip count and T to ICP_TOL (translation of the lever
    # arm) on every verification; one rank runs icp_step's arithmetic and
    # reproduces it bit for bit
    icp_err = 0.0
    for (T, it, conv, fit), (args, w) in zip(r0["icp"], want["icp"]):
        wT = w.T.cpu().numpy()
        e = max(float(np.abs(T[:3, :3] - wT[:3, :3]).max()),
                float(np.abs(T[:3, 3] - wT[:3, 3]).max()) / _lever(args[0], args[1]))
        icp_err = max(icp_err, e)
        if it != int(w.iterations) or e > ICP_TOL \
                or (one_rank and not (np.array_equal(T, wT) and conv == bool(w.converged))):
            raise AssertionError(f"mesh {name}: icp {it} iterations against "
                                 f"{int(w.iterations)}, |ΔT| {e:.3g}, bit-equal "
                                 f"{np.array_equal(T, wT)} (one rank: {one_rank})")
    pgo_err = {}
    for n, got in zip(want["pgo"], r0["pgo"]):
        pgo_err[n] = float(np.abs(got - want["pgo"][n]).max())
        if pgo_err[n] > PGO_TOL:
            raise AssertionError(f"mesh {name}: pgo {n} |Δpose| {pgo_err[n]:.3g} > {PGO_TOL}")
    # slam_superstep against its components: the group's own align and
    # solve bit for bit, make_descriptor bit for bit, the single-device
    # retrieval's nearest entry (its distance to 1e-5)
    for k, ((pose, it, desc, cand, opt), (wdesc, wbest, wdist)) in enumerate(
            zip(r0["superstep"], want["superstep"])):
        a_pose, a_it = r0["ndt"][k]
        same_dist = abs(float(cand[0]) - wdist) <= 1e-5 if np.isfinite(wdist) \
            else not np.isfinite(float(cand[0]))
        if not (np.array_equal(pose, a_pose) and it == a_it and np.array_equal(desc, wdesc)
                and np.array_equal(opt, r0["pgo"][0]) and int(cand[1]) == wbest
                and same_dist):
            raise AssertionError(f"mesh {name}: slam_superstep on scan {k} differs from its "
                                 f"components: candidate {cand} against ({wdist}, {wbest})")
    launches = ranks[0]["launches"]
    total = {k: sum(v[k] for v in launches.values())
             for k in (*MESH_KERNELS, *MESH_PATH_KEYS, "collectives", "host_staged")}
    missing = [k for k in (*MESH_KERNELS, "icp_live_trips") if total[k] < 1]
    staged = total["host_staged"] > 0
    if missing or staged != (ranks[0]["backend"] == "gloo" and ranks[0]["device"] != "cpu"):
        raise AssertionError(f"mesh {name}: kernels not launched {missing}, host-staged "
                             f"collectives {total['host_staged']}")
    return {"ranks": len(ranks), "ms": ranks[0]["ms"], "launches_per_rank": launches,
            "ndt_same_iterations": same, "ndt_max_dpose": dpose,
            "sc_retrievals": len(want["sc"]), "sc_found": sum(int(f) for _i, f, _d in r0["sc"]),
            "icp_verifications": len(want["icp"]), "icp_max_err": icp_err,
            "pgo_max_dpose": pgo_err, "total": total}


def phase_mesh(smi: str, rec: dict) -> dict:
    """The mesh phase: the new entry points against their plain versions,
    then rank groups through `parallel/distributed.launch` (gloo at D = 2
    and 4 on card 0, NCCL at D = 1, and NCCL at D = min(4, cards) where
    there are several cards) replaying the circuit's aligns, retrievals,
    verifications and graphs, each held to the single-device results."""
    from xchu_slam_tpu_torch.parallel import distributed

    entry = _mesh_entry_points(smi, rec)
    cards = torch.cuda.device_count()
    groups = list(MESH_GROUPS)
    if cards > 1:
        groups.append(("nccl", min(4, cards)))
    else:
        print("mesh: NCCL over several cards not run: the machine has one card")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xst_mesh_inputs_")
    try:
        path = os.path.join(tmp, "inputs.pt")
        want = _mesh_inputs(rec, path)
        records = {}
        for backend, world in groups:
            name = f"{backend} D={world}"
            t0 = time.perf_counter()
            ranks = distributed.launch(world, "chip_smoke:mesh_rank", (path,), backend=backend,
                                       device="cuda", timeout_s=MESH_GROUP_TIMEOUT,
                                       path=(_HERE,))
            for rk in ranks:
                rk["backend"] = backend
            r = records[name] = _check_group(name, ranks, want)
            r["seconds"] = time.perf_counter() - t0
            ms = " ".join(f"{op} {v:.3f}" for op, v in r["ms"].items())
            print(f"mesh [{smi}] {name}: ms an op (CUDA events, rank 0): {ms}; launches per "
                  f"rank {json.dumps(r['launches_per_rank'])}; ndt same iterations "
                  f"{r['ndt_same_iterations']}/{len(want['ndt'])}, max |Δpose| "
                  f"{r['ndt_max_dpose']:.3g}; sc {r['sc_retrievals']} retrievals, "
                  f"{r['sc_found']} found, every candidate equal; icp "
                  f"{r['icp_verifications']} verifications, the same trip counts, max |ΔT| "
                  f"{r['icp_max_err']:.3g}; pgo "
                  f"{json.dumps(r['pgo_max_dpose'])}; ranks bit-identical; "
                  f"{r['seconds']:.1f} s")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh: {len(records)} groups in {time.perf_counter() - t_phase:.1f} s")
    return {"entry": entry, "groups": records}


MESH_ENGINE_D1_SCANS = 32     # (b): NCCL D = 1 through DeviceSlamPipeline(mesh=)
# (e) and (d) are short runs, so that the whole run keeps within its time limit
MESH_ENGINE_D4_SCANS = 16     # (e): the SC circuit's first scans at gloo D = 4
MESH_ENGINE_CONT_SCANS = 64   # (d): the continued session
MESH_ENGINE_KITTI_SCANS = 32  # (f): run-kitti's HDL-64-density files
MESH_ENGINE_PROCS = 3         # (g): render workers a rank
MESH_ENGINE_PROCS_SCANS = 64  # (g): the circuit's first scans
MESH_ENGINE_TOL = 1e-4        # m and rad: (b)'s rows against phase 8's
MESH_ENGINE_KF = 2            # keyframes within ±2 of phase 8's


def _single_reference(pipe, summary: dict) -> dict:
    """What phase 5c holds its runs to, from phase 8's single-device run of
    the circuit (`run-sim --engine device --chunk 16`): its summary's
    keyframes, loops, ATE, rate and stage seconds, its per-scan odometry,
    and its keyframes over the first MESH_ENGINE_D4_SCANS scans."""
    return {"summary": {k: summary[k] for k in ("keyframes", "loops", "ate_rmse_m",
                                                 "scans_per_sec", "stage_seconds")},
            "odometry": pipe.odometry_trajectory(),
            "kf_d4": sum(1 for r in pipe.odom_log[:MESH_ENGINE_D4_SCANS] if r["keyframe"])}


def _mesh_engine_feed(pipe, first: int, n_scans: int, device) -> None:
    """Feed the circuit's scans [first, first + n_scans) to `pipe` in chunks
    of DEV_CHUNK, staged on `device`, with the stamps run-sim gives them."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io.prefetch import DeviceChunkPrefetcher
    from xchu_slam_tpu_torch.utils import sim

    gt_stamps, gt, world = cli._sim_world_and_traj(SCANS, RADIUS, SEED)
    lazy = sim.RenderedScans(world, gt, seed=SEED, n_points=24_000)
    scans = [lazy[i] for i in range(first, first + n_scans)]
    base = first
    with DeviceChunkPrefetcher(scans, capacity=pipe.cfg.filter.max_raw_points, chunk=DEV_CHUNK,
                               depth=2, threads=2, device=device) as pf:
        for clouds, n_real in pf:
            idx = np.minimum(base + np.arange(DEV_CHUNK), SCANS - 1)
            pipe.process_chunk(clouds, gt_stamps[idx], n_real)
            base += n_real


def mesh_engine_rank(mesh, n_scans: int) -> dict:
    """One rank of phase 5c (b): the circuit's first `n_scans` through
    `DeviceSlamPipeline(mesh=)` at run-sim's width; its per-scan odometry,
    kernel launches, collectives and host synchronisations."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline
    from xchu_slam_tpu_torch.utils.profiling import count_host_syncs

    pipe = DeviceSlamPipeline(cli.sim_config(), log_capacity=8192, mesh=mesh)
    t0 = time.perf_counter()
    with count_host_syncs() as syncs:
        _mesh_engine_feed(pipe, 0, n_scans, mesh.device)
        pipe.finalize()
    torch.cuda.synchronize()
    return {"odometry": pipe.odometry_trajectory(), "seconds": time.perf_counter() - t0,
            "stage_seconds": dict(pipe.stage_seconds),
            "counters": {**cli.rank_counters(pipe), "host_syncs": syncs["syncs"]}}


def mesh_resume_rank(mesh, ckpt: str, chunks: int) -> dict:
    """One rank of phase 5c (a)'s resume: the mesh run's checkpoint restored
    on this rank (`load_checkpoint(mesh=)`) and fed `chunks` chunks."""
    from xchu_slam_tpu_torch.utils import checkpoint

    again = checkpoint.load_checkpoint(ckpt, mesh=mesh)
    saved = again._scans_fed
    _mesh_engine_feed(again, saved, chunks * DEV_CHUNK, mesh.device)
    again.finalize()
    return {"saved": saved, "odometry": again.odometry_trajectory()}


def _mesh_path(counters: dict) -> dict:
    """A rank's launches and live ICP trips as the kernels line's paths hold
    them."""
    return {k: counters[k] for k in (*MESH_KERNELS, *MESH_PATH_KEYS)}


def _check_mesh_engine_run(name: str, smi: str, summary: dict, ranks: list, aligns: int,
                           ref: dict, seconds: float) -> dict:
    """Print a mesh run (every rank's launches, host synchronisations and
    collectives a scan, scans/s and stage seconds beside phase 8's) and
    check its kernels on every rank: the NDT kernel's shard pass on every
    align and the single-device align kernel never, and where the rank
    verified a loop the NN kernel, icp_partial and icp_solve; the PGO kernel
    on every rank (the final solve). Returns rank 0's launches."""
    scans = summary["scans"]
    counters = [r["counters"] for r in ranks]
    line = {k: summary.get(k) for k in ("scans", "keyframes", "loops", "ate_rmse_m",
                                        "scans_per_sec", "stream_scans_per_sec", "reader")}
    line.update(mesh=summary["mesh"], backend=summary["backend"],
                ranks_agree=summary["ranks_agree"], pose_hash=summary["pose_hash"],
                launches_per_rank=[_mesh_path(c) for c in counters],
                verifications_per_rank=[c["icp_verifications"] for c in counters],
                host_syncs_per_scan=[None if c["host_syncs"] is None
                                     else round(c["host_syncs"] / scans, 2) for c in counters],
                collectives_per_scan=[round(c["collectives"] / scans, 2) for c in counters],
                host_staged_per_scan=[round(c["host_staged"] / scans, 2) for c in counters],
                chunk_readbacks=[c["chunk_readbacks"] for c in counters],
                chunk_attribution=summary.get("chunk_attribution"),
                stage_seconds=summary.get("stage_seconds"),
                phase8_scans_per_sec=ref["scans_per_sec"],
                phase8_stage_seconds=ref["stage_seconds"], seconds=round(seconds, 1))
    print(f"mesh_engine [{smi}] {name}: " + json.dumps(line))
    for r, c in enumerate(counters):
        if c["ndt_pass"] < aligns or c["ndt"] != 0:
            raise AssertionError(f"mesh_engine {name}: rank {r} made {c['ndt_pass']} shard "
                                 f"passes over {aligns} aligns and {c['ndt']} align launches")
        if c["icp_verifications"] and min(c["nn"], c["icp_partial"], c["icp_solve"],
                                          c["icp_live_trips"]) < 1:
            raise AssertionError(f"mesh_engine {name}: rank {r} verified "
                                 f"{c['icp_verifications']} loops with launches {c}")
        if c["pgo"] < 1:
            raise AssertionError(f"mesh_engine {name}: rank {r} launched no PGO kernel")
    if not summary["ranks_agree"]:
        raise AssertionError(f"mesh_engine {name}: the ranks disagree")
    return _mesh_path(counters[0])


def phase_mesh_engine(smi: str, single: dict | None) -> dict:
    """The mesh device engine (`DeviceSlamPipeline(mesh=)`) through the
    CLI's functions at run-sim's width, each run a group of ranks started by
    `cli.run_on_mesh` (fresh interpreters; gloo with the ranks sharing card
    0 where the machine has fewer cards than ranks, NCCL a card a rank
    otherwise), held to phase 8's single-device run of the circuit
    (`single`, `_single_reference`; with --mesh-only, where phase 8 does not
    run, that run is made here first). Returns the launches of every run's
    rank 0 by path."""
    from xchu_slam_tpu_torch import cli
    from xchu_slam_tpu_torch.io import kitti
    from xchu_slam_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    if single is None:
        pipe, summary = cli.run_sim(SCANS, RADIUS, SEED, "cuda", engine="device",
                                    chunk=DEV_CHUNK)
        single = _single_reference(pipe, summary)
        del pipe
        torch.cuda.empty_cache()
    ref, single_odo, kf64 = single["summary"], single["odometry"], single["kf_d4"]
    print(f"mesh_engine [{smi}]: phase 8's run (run-sim --engine device --chunk 16, one "
          f"device) " + json.dumps(ref))
    gt_rel = cli._gt_in_map_frame(cli._sim_world_and_traj(SCANS, RADIUS, SEED)[1])
    paths = {}
    base = dict(radius=RADIUS, seed=SEED, device="cuda", engine="device", chunk=DEV_CHUNK)

    def run(name, world, command="run-sim", **kw):
        t0 = time.perf_counter()
        summary, ranks = cli.run_on_mesh(command, kw, world)
        aligns = summary["scans"] - 1
        paths[f"mesh_engine {name}"] = _check_mesh_engine_run(
            name, smi, summary, ranks, aligns, ref, time.perf_counter() - t0)
        return summary, ranks

    with tempfile.TemporaryDirectory(prefix="xchu_mesh_engine_") as tmp:
        # (a) the circuit at D = 2 with checkpoints and the export
        out = os.path.join(tmp, "run")
        a, ranks = run("run-sim D=2", 2, scans=SCANS, checkpoint_every=CHECKPOINT_EVERY,
                       out=out, **base)
        paths_a = a.pop("artifacts")
        if abs(a["keyframes"] - ref["keyframes"]) > MESH_ENGINE_KF or a["loops"] < 1 \
                or not a["ate_rmse_m"] < 1.0:
            raise AssertionError(f"mesh_engine run-sim D=2: {a['keyframes']} keyframes "
                                 f"(phase 8: {ref['keyframes']}), {a['loops']} loops, aligned "
                                 f"ATE {a['ate_rmse_m']} m (phase 8: {ref['ate_rmse_m']} m)")
        stamps, est = kitti.read_tum(paths_a["odom_tum"])
        with open(paths_a["odom_log"]) as f:
            log_rows = sum(1 for _ in f)
        if len(stamps) != a["keyframes"] or not np.isfinite(est).all() or log_rows != SCANS:
            raise AssertionError("mesh_engine run-sim D=2: --out does not hold the run")
        print(f"mesh_engine: D=2 --out read back (rank 0 wrote it): odom_tum {len(stamps)} "
              f"rows, odom_log {log_rows} rows, {len(paths_a)} files; aligned ATE "
              f"{a['ate_rmse_m']} m beside phase 8's {ref['ate_rmse_m']} m")
        odo_a = ranks[0]["odometry"]
        ckpt = os.path.join(out, "checkpoint.npz")
        t0 = time.perf_counter()
        backend, dev = cli._mesh_transport(2, "cuda")
        resumed = distributed.launch(2, "chip_smoke:mesh_resume_rank", (ckpt, RESUME_CHUNKS),
                                     backend=backend, device=dev,
                                     timeout_s=cli.mesh_timeout(RESUME_CHUNKS * DEV_CHUNK),
                                     path=(_HERE,))
        lo = resumed[0]["saved"]
        hi = lo + RESUME_CHUNKS * DEV_CHUNK
        for r, res in enumerate(resumed):
            if not np.array_equal(res["odometry"][lo:hi], odo_a[lo:hi]):
                raise AssertionError(f"mesh_engine: rank {r}'s resumed rows {lo}-{hi - 1} "
                                     "differ from the uninterrupted mesh run's")
        print(f"mesh_engine: D=2 checkpoint of scan {lo} resumed on the mesh for "
              f"{RESUME_CHUNKS} chunks, rows {lo}-{hi - 1} bit-identical to the "
              f"uninterrupted run's on both ranks ({time.perf_counter() - t0:.1f} s)")

        # (g) the circuit's first scans at D = 2, each rank with its render workers
        n = MESH_ENGINE_PROCS_SCANS
        g, ranks = run(f"run-sim --render-procs {MESH_ENGINE_PROCS} D=2", 2, scans=n,
                       render_procs=MESH_ENGINE_PROCS, **base)
        against = "(a)'s first rows"
        want = odo_a[:n]
        if not np.array_equal(ranks[0]["odometry"], want):
            # not prefix-stable: the same scans without workers
            _s, plain = cli.run_on_mesh("run-sim", {**base, "scans": n}, 2)
            against, want = f"a {n}-scan run without workers", plain[0]["odometry"]
        for r, res in enumerate(ranks):
            if not np.array_equal(res["odometry"], want):
                raise AssertionError(f"mesh_engine (g): rank {r}'s rows differ from {against}")
        print(f"mesh_engine [{smi}] (g): {n} scans with {MESH_ENGINE_PROCS} render workers a "
              f"rank, rows bit-identical to {against} on both ranks; inline renders "
              f"{g['inline_renders']}, {g['render_processes']} render processes on "
              f"{g['cpu_count']} cores; mean wait a chunk "
              f"{g['chunk_attribution']['mean_wait_ms']} ms beside (a)'s "
              f"{a['chunk_attribution']['mean_wait_ms']} ms without workers")
        if g["inline_renders"] != [0, 0]:
            raise AssertionError(f"mesh_engine (g): inline renders {g['inline_renders']}")

        # (b) NCCL D = 1 through DeviceSlamPipeline(mesh=), against phase 8's rows
        t0 = time.perf_counter()
        one = distributed.launch(1, "chip_smoke:mesh_engine_rank", (MESH_ENGINE_D1_SCANS,),
                                 backend="nccl", device="cuda",
                                 timeout_s=cli.mesh_timeout(MESH_ENGINE_D1_SCANS),
                                 path=(_HERE,))[0]
        err = float(np.abs(one["odometry"] - single_odo[:MESH_ENGINE_D1_SCANS]).max())
        c = one["counters"]
        paths["mesh_engine library nccl D=1"] = _mesh_path(c)
        print(f"mesh_engine [{smi}] library nccl D=1: {MESH_ENGINE_D1_SCANS} scans, max "
              f"|Δrow| against phase 8's {err:.3g}; launches {json.dumps(c)}; host syncs "
              f"{c['host_syncs'] / MESH_ENGINE_D1_SCANS:.2f} and collectives "
              f"{c['collectives'] / MESH_ENGINE_D1_SCANS:.2f} a scan; "
              f"{MESH_ENGINE_D1_SCANS / one['seconds']:.2f} scans/s, stage seconds "
              f"{json.dumps({k: round(v, 3) for k, v in one['stage_seconds'].items()})} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not err <= MESH_ENGINE_TOL or c["ndt_pass"] < MESH_ENGINE_D1_SCANS - 1 \
                or c["ndt"] != 0:
            raise AssertionError(f"mesh_engine library nccl D=1: max |Δrow| {err}, "
                                 f"launches {c}")

        # (c) ISC with the IMU and wheel guesses and GPS factors at D = 2
        isc, ranks = run("run-sim isc imu wheel gps D=2", 2, scans=SCANS, loop_method="isc",
                         imu=True, wheel=True, gps=True, **base)
        guess = [r["counters"]["guess"] for r in ranks]
        if isc["loops"] < 1 or min(guess) < SCANS - 1:
            raise AssertionError(f"mesh_engine isc D=2: {isc['loops']} loops, guess "
                                 f"launches {guess}")

        # (d) the session continued from (a)'s checkpoint at D = 2
        cont, ranks = run("run-sim --continue-session D=2", 2, scans=MESH_ENGINE_CONT_SCANS,
                          continue_from=ckpt, **base)
        reloc = float(np.linalg.norm(ranks[0]["continuation"]["reloc_pose"][:3]
                                     - gt_rel[0, :3, 3]))
        new_kf = cont["continuation"]["new_keyframes"]
        print(f"mesh_engine: continued on the mesh: relocalized {reloc:.4f} m from the "
              f"truth, {new_kf} new keyframes, {cont['loops']} loops")
        if not reloc < RELOC_TOL_M or new_kf < MIN_NEW_KEYFRAMES:
            raise AssertionError(f"mesh_engine continue D=2: relocalized {reloc} m, "
                                 f"{new_kf} new keyframes")

    # (e) the SC circuit's first scans at D = 4
    e, _ranks = run("run-sim D=4", 4, scans=MESH_ENGINE_D4_SCANS, **base)
    if abs(e["keyframes"] - kf64) > MESH_ENGINE_KF:
        raise AssertionError(f"mesh_engine D=4: {e['keyframes']} keyframes over "
                             f"{MESH_ENGINE_D4_SCANS} scans, phase 8's {kf64}")

    # (f) run-kitti on HDL-64-density files at D = 2
    with tempfile.TemporaryDirectory(prefix="xchu_mesh_kitti_") as tmp:
        files = _sources_call("mesh kitti files", [{"kind": "write_kitti", "root": tmp,
                                                    "n_scans": MESH_ENGINE_KITTI_SCANS}])[0]
        k, _ranks = run("run-kitti D=2", 2, command="run-kitti",
                        velodyne_dir=files["velodyne_dir"], gt=files["gt"],
                        out=os.path.join(tmp, "out"), engine="device", device="cuda")
        if k["reader"] != "native" or k["keyframes"] < 2 or not k["ate_rmse_m"] < 1.0:
            raise AssertionError(f"mesh_engine run-kitti D=2: {k}")
    seconds = time.perf_counter() - t_phase
    print(f"mesh_engine: {len(paths)} runs in {seconds:.1f} s")
    return {"paths": paths, "seconds": seconds}


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
    if "--sources-child" in sys.argv[1:]:
        sources_child(json.loads(sys.argv[sys.argv.index("--sources-child") + 1]))
        return 0
    t0 = time.perf_counter()

    def mark(done: str) -> None:
        # where the whole run's time limit goes
        print(f"elapsed after {done}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    smi = phase_device()
    ptxas = phase_build()
    mark("build")
    if "--sources-only" in sys.argv[1:]:
        phase_sources(smi)
        return 0
    mesh_only = "--mesh-only" in sys.argv[1:]
    only_device = ("--device-only" in sys.argv[1:] or "--extras-only" in sys.argv[1:]
                   or mesh_only)
    rec = None if only_device else phase_kernel()
    if "--kernel-only" in sys.argv[1:]:
        return 0
    ndt_rec = None if only_device else phase_ndt_kernel(smi)
    pgo_rec = None if only_device else phase_pgo_kernel(smi)
    icp_rec = None if only_device else phase_icp_kernel(smi)
    guess_rec = None if only_device else phase_guess_kernel(smi)
    mark("the kernel phases")
    if "--kernels-only" in sys.argv[1:]:
        return 0
    if "--modes-only" in sys.argv[1:]:
        phase_ndt_modes(smi, ptxas, ndt_rec["floor"])
        phase_ndt_regather(smi, ptxas, ndt_rec)
        phase_pgo_jacobi(smi, pgo_rec["floor"])
        phase_mode_circuits()
        return 0
    # the mesh phase runs in the whole run and with --mesh-only
    run_mesh = mesh_only or not only_device
    record = {} if run_mesh else None
    launches, host_summary = phase_main(record)
    mark("main")
    mesh = phase_mesh(smi, record) if run_mesh else None
    mark("mesh")
    del record
    if mesh_only:
        phase_mesh_engine(smi, None)
        return 0
    if "--extras-only" in sys.argv[1:]:
        phase_extras(smi, launches, host_summary)
        return 0
    if "--device-only" in sys.argv[1:]:
        phase_device_session(smi, phase_device_engine(host_summary))
        return 0
    # the mesh groups' launches a rank (the single-device kernels' keys too)
    mesh_paths = {f"mesh {name}": _mesh_path(g["total"]) for name, g in mesh["groups"].items()}
    by_path = {"main": launches, **mesh_paths, **phase_session()}
    phase_determinism()
    mark("session and determinism")
    dev = phase_device_engine(host_summary)
    by_path.update(dev["paths"])
    mark("device")
    # the mesh engine's runs, held to phase 8's: rank 0's launches
    mesh_paths.update(phase_mesh_engine(smi, dev.pop("single"))["paths"])
    by_path.update(mesh_paths)
    mark("mesh_engine")
    sess = phase_device_session(smi, dev)
    by_path.update(sess["paths"])
    del dev
    mark("device_session")
    # the modes: their kernels against their plain versions, then the circuit
    ndt_modes = phase_ndt_modes(smi, ptxas, ndt_rec["floor"])
    regather = phase_ndt_regather(smi, ptxas, ndt_rec)
    pgo_jacobi = phase_pgo_jacobi(smi, pgo_rec["floor"])
    circuits = phase_mode_circuits()
    for setting, row in circuits.items():
        by_path[f"device {setting}"] = row.pop("launches")
    for name, rec_m in ndt_modes.items():
        ls, nb = name.split("+")
        setting = f"ndt.ls_mode={ls}" if ls != "backtrack" else f"ndt.neighbor_mode={nb}"
        rec_m["circuit"] = circuits[setting]
    ndt_modes[f"backtrack+direct7 regather_dist={REGATHER_DIST}"] = regather
    pgo_jacobi["circuit"] = circuits["pgo.precond=jacobi"]
    mark("modes")
    by_path.update(phase_sources(smi)["paths"])
    mark("sources")
    by_path.update(phase_extras(smi, launches, host_summary)["paths"])

    def per_path(key):
        return {k: v[key] for k, v in by_path.items()}

    kernels = [{"name": "nn_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/nn_kernel.cu",
                "replaces": "xchu_slam_tpu/ops/pallas/nn_kernel.py:29",
                "launches": launches["nn"], "launches_by_path": per_path("nn"), **rec,
                "shard_ms": mesh["entry"]["nn_shard_ms"],
                "ptxas": {k: v for k, v in ptxas.items() if k in ("first version", "merge",
                                                                    "scan")}},
               {"name": "ndt_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/ndt_kernel.cu",
                "replaces": "none: xchu_slam_tpu/ops/ndt.py:477 and :539 (two "
                            "lax.while_loop that the reference leaves to XLA)",
                "launches": launches["ndt"], "launches_by_path": per_path("ndt"),
                **ndt_rec, "ptxas": {"ndt align": ptxas["ndt align"]}, "modes": ndt_modes},
               {"name": "pgo_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/pgo_kernel.cu",
                "replaces": "none: xchu_slam_tpu/models/pose_graph.py:221, :251, :257 and "
                            ":459 (lax.scan, two associative_scan, lax.while_loop that the "
                            "reference leaves to XLA)",
                "launches": launches["pgo"], "launches_by_path": per_path("pgo"),
                **pgo_rec, "ptxas": {k: ptxas[k] for k in ("pgo", "pgo first version",
                                                          "pgo jacobi")},
                "jacobi": pgo_jacobi},
               {"name": "icp_step", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/icp_kernel.cu",
                "replaces": "none: xchu_slam_tpu/ops/icp.py:114-173 (the body of a "
                            "lax.while_loop that the reference leaves to XLA)",
                "launches": launches["icp_step"], "launches_by_path": per_path("icp_step"),
                "live_trips_by_path": per_path("icp_live_trips"), **icp_rec,
                "ptxas": {k: ptxas[k] for k in ("icp step", "icp step first version", "icp init",
                                                 "icp fitness")}},
               *({"name": name, "route": "cuda", "source": f"xchu_slam_tpu_torch/csrc/{src}",
                  "replaces": replaces,
                  "launches": mesh_paths["mesh_engine run-sim D=2"][key],
                  "launches_by_path": {k: v[key] for k, v in mesh_paths.items()},
                  **mesh["entry"][name], "ptxas": {k: ptxas[k] for k in tags}}
                 for name, src, key, tags, replaces in (
                     ("ndt_shard_pass", "ndt_kernel.cu", "ndt_pass",
                      ("ndt pass", "ndt pass 1", "ndt pass 27"),
                      "none: the passes of xchu_slam_tpu/ops/ndt.py:574 (align with a mesh "
                      "axis), reduced by shard_allsum, that the reference leaves to XLA"),
                     ("icp_partial", "icp_kernel.cu", "icp_partial", ("icp partial",),
                      "none: the moment sums of xchu_slam_tpu/ops/icp.py:114-129 (align "
                      "with a mesh axis) that the reference leaves to XLA"),
                     ("icp_solve", "icp_kernel.cu", "icp_solve", ("icp solve",),
                      "none: xchu_slam_tpu/ops/icp.py:130-173 (the update and stop tests "
                      "after the reduction) that the reference leaves to XLA"))),
               {"name": "guess_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/guess_kernel.cu",
                "replaces": "none: xchu_slam_tpu/models/device_pipeline.py:341-369 (_ext_guess: "
                            "the two lax.scan of ops/imu.py that the reference leaves to XLA)",
                "launches": by_path["device_session"]["guess"],
                "launches_by_path": per_path("guess"), **guess_rec,
                "ptxas": {"guess": ptxas["guess"]}}]
    print(f"total: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
