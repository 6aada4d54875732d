#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`xchu_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; fails if there is no CUDA device or TF32 is on
  2. build    nvcc-compiles the NN kernel (csrc/nn_kernel.cu, sm_90a) and
              prints ptxas's registers, shared memory and spills (none allowed)
  3. kernel   the kernel against its first version (idx and d² bit-equal)
              and its plain PyTorch version (d² to rtol = atol = 1e-4, valid
              indices, ties at the lowest index) on the card, over shapes and
              masks that walk the edges of its split of the targets; then
              the wrapper's host cost and, at the ICP shape 4096 × 16384, ms
              per launch over many launches per CUDA-event pair, in turns:
              first version, kernel, kernel, first version, plain, library
  4. main     the `run-sim` host engine on the 430-scan, 55 m circuit at
              the default config; needs NN kernel launches ≥ 1, loops ≥ 1
              and aligned ATE < 1.0 m
  5. determinism  the first 60 scans twice from a fresh state: per-scan
              poses bit-identical
Then one JSON line of kernel records and, last, the result line.
`--kernel-only` stops after phase 3 and prints no result line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SCANS, RADIUS, SEED = 430, 55.0, 0
DET_SCANS = 60
TOL = 1e-4
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# mangled-name fragments of csrc/nn_kernel.cu's kernels, and what they are
PTXAS_NAMES = (("nn_kernel_simple", "first version"),
               ("nn_merge_kernel", "merge"),
               ("nn_kernel", "scan"))


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
    """Build the kernels; print what ptxas says of each (registers, shared
    memory, spills) and fail on a spill."""
    from xchu_slam_tpu_torch.ops.cuda import nn_kernel

    lib, secs, log = nn_kernel.build()
    print(f"build: {lib.name} in {secs:.2f} s")
    print(log.strip(), file=sys.stderr)
    figures = {}
    for entry, spill, regs, rest in re.findall(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
            r"Used (\d+) registers([^\n]*)", log, re.S):
        name = next(n for tag, n in PTXAS_NAMES if tag in entry)
        smem = re.search(r"(\d+) bytes smem", rest)
        figures[name] = {"registers": int(regs),
                         "smem_bytes": int(smem.group(1)) if smem else 0,
                         "spill_bytes": int(spill)}
    print("ptxas: " + json.dumps(figures))
    if set(figures) != {n for _tag, n in PTXAS_NAMES}:
        raise AssertionError("ptxas reported no figures for a kernel")
    if any(f["spill_bytes"] for f in figures.values()):
        raise AssertionError("a kernel spills registers")
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


def phase_main() -> int:
    from xchu_slam_tpu_torch.cli import run_sim
    from xchu_slam_tpu_torch.ops.cuda import nn_kernel

    nn_kernel.launches = 0
    pipe, summary = run_sim(SCANS, RADIUS, SEED, "cuda")
    launches = nn_kernel.launches
    odo = pipe.odometry_trajectory()
    _, _, kf_opt = pipe.keyframe_trajectory()
    summary.update(icp_verifications=pipe.icp_verifications, nn_launches=launches)
    print("main: " + json.dumps(summary))
    if odo.shape != (SCANS - 1, 6) or not np.isfinite(odo).all() \
            or not np.isfinite(kf_opt).all():
        raise AssertionError("trajectory has the wrong shape or non-finite poses")
    if launches < 1:
        raise AssertionError("the main path launched no NN kernel")
    if summary["loops"] < 1:
        raise AssertionError("the circuit closed no loop")
    if not summary["ate_rmse_m"] < 1.0:
        raise AssertionError(f"aligned ATE {summary['ate_rmse_m']} m ≥ 1.0 m")
    return launches


def phase_determinism() -> None:
    from xchu_slam_tpu_torch.cli import run_sim

    runs = []
    for _ in range(2):
        poses = []
        run_sim(DET_SCANS, RADIUS, SEED, "cuda",
                on_scan=lambda i, r: poses.append(r["pose"]))
        runs.append(np.stack(poses))
    if not np.array_equal(runs[0], runs[1]):
        diff = np.abs(runs[0] - runs[1]).max()
        raise AssertionError(f"reruns differ (max |Δpose| {diff})")
    print(f"determinism: {DET_SCANS} scans twice, poses bit-identical")


def main() -> int:
    sys.path[:0] = [_HERE, os.path.join(_HERE, "tests")]
    t0 = time.perf_counter()
    phase_device()
    ptxas = phase_build()
    rec = phase_kernel()
    if "--kernel-only" in sys.argv[1:]:
        return 0
    launches = phase_main()
    phase_determinism()
    kernels = [{"name": "nn_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/nn_kernel.cu",
                "replaces": "xchu_slam_tpu/ops/pallas/nn_kernel.py:29",
                "launches": launches, **rec, "ptxas": ptxas}]
    print(f"total: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
