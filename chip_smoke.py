#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`xchu_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; fails if there is no CUDA device or TF32 is on
  2. build    nvcc-compiles the NN kernel (csrc/nn_kernel.cu, sm_90a)
  3. kernel   the kernel against its plain PyTorch version on the card,
              5 cases, d² to rtol = atol = 1e-4 and valid indices; median
              CUDA-event times at the ICP shape 4096 × 16384
  4. main     the `run-sim` host engine on the 430-scan, 55 m circuit at
              the default config; needs NN kernel launches ≥ 1, loops ≥ 1
              and aligned ATE < 1.0 m
  5. determinism  the first 60 scans twice from a fresh state: per-scan
              poses bit-identical
Then one JSON line of kernel records and, last, the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SCANS, RADIUS, SEED = 430, 55.0, 0
DET_SCANS = 60
TOL = 1e-4


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


def phase_build() -> None:
    from xchu_slam_tpu_torch.ops.cuda import nn_kernel

    lib, secs, log = nn_kernel.build()
    print(f"build: {lib.name} in {secs:.2f} s")
    if log:
        print(log.strip(), file=sys.stderr)


def _cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn()` in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel() -> dict:
    from xchu_slam_tpu_torch.ops.cuda import nn_kernel

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")

    def cloud(n, scale):
        return rng.normal(size=(n, 3)).astype(np.float32) * scale

    cases = []
    m = np.ones(16384, bool)
    cases.append(("4096x16384", cloud(4096, 30.0), cloud(16384, 30.0), m))
    cases.append(("ragged 1000x3000", cloud(1000, 10.0), cloud(3000, 10.0),
                  np.ones(3000, bool)))
    m = np.ones(4096, bool)
    m[4096 // 3:4096 // 2] = False
    cases.append(("masked stretch", cloud(1024, 10.0), cloud(4096, 10.0), m))
    m = np.zeros(2048, bool)
    m[5] = True
    cases.append(("all but one masked", cloud(1024, 1.0), cloud(2048, 1.0), m))
    cases.append(("all masked", cloud(1024, 1.0), cloud(2048, 1.0),
                  np.zeros(2048, bool)))

    max_err = 0.0
    for name, s, t, msk in cases:
        s_d, t_d = torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)
        m_d = torch.from_numpy(msk).to(dev)
        idx, d2 = nn_kernel.nearest_neighbor(s_d, t_d, m_d)
        ref_idx, ref_d2 = nn_kernel.nearest_neighbor_ref(s_d, t_d, m_d)
        torch.cuda.synchronize()
        idx, d2, ref_d2 = idx.cpu().numpy(), d2.cpu().numpy(), ref_d2.cpu().numpy()
        if msk.any():
            if not msk[idx].all():
                raise AssertionError(f"{name}: an index points at a masked target")
            exact = ((s - t[idx]) ** 2).sum(-1)
            np.testing.assert_allclose(d2, exact, rtol=TOL, atol=TOL)
        elif not ((idx == 0).all() and (d2 == 1e30).all()):
            raise AssertionError(f"{name}: an all-masked row must give (0, 1e30)")
        np.testing.assert_allclose(d2, ref_d2, rtol=TOL, atol=TOL, err_msg=name)
        max_err = max(max_err, float(np.abs(d2 - ref_d2).max()))

    s_d, t_d, m_d = (torch.from_numpy(a).to(dev) for a in cases[0][1:])
    # plain, kernel, kernel, plain: report the mean of each pair
    p1 = _cuda_ms(lambda: nn_kernel.nearest_neighbor_ref(s_d, t_d, m_d))
    k1 = _cuda_ms(lambda: nn_kernel.nearest_neighbor(s_d, t_d, m_d))
    k2 = _cuda_ms(lambda: nn_kernel.nearest_neighbor(s_d, t_d, m_d))
    p2 = _cuda_ms(lambda: nn_kernel.nearest_neighbor_ref(s_d, t_d, m_d))
    ms, plain_ms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    print(f"kernel: {len(cases)} cases agree to rtol=atol={TOL} "
          f"(max |Δd²| {max_err:.3g}); "
          f"4096x16384 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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
    sys.path.insert(0, _HERE)
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    rec = phase_kernel()
    launches = phase_main()
    phase_determinism()
    kernels = [{"name": "nn_kernel", "route": "cuda",
                "source": "xchu_slam_tpu_torch/csrc/nn_kernel.cu",
                "replaces": "xchu_slam_tpu/ops/pallas/nn_kernel.py:29",
                "launches": launches, **rec}]
    print(f"total: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
