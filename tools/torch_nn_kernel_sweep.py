#!/usr/bin/env python3
"""Sweep of the port's nearest-neighbour CUDA kernel on one GPU.

    python3 tools/torch_nn_kernel_sweep.py [--sass FILE]

Builds `xchu_slam_tpu_torch/csrc/nn_kernel.cu` as the wrapper does and, at
the ICP shape 4096 × 16384, runs it at several numbers of target slices per
source tile (the wrapper's `plan` picks one). Each is checked bit-equal to
the first version of the kernel and timed on the card alone (50 launches per
CUDA graph, 10 replays per event pair, outputs preallocated), in turns with
the first version. At the wrapper's own split the kernel is also timed at
other N and M, which separates the per-launch overhead from the per-pair
rate, and the card's clock and power are read under its load. `--sass FILE`
writes the library's SASS (cuobjdump) to FILE. One JSON line per result; the
card's name, power limit and clocks come first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from xchu_slam_tpu_torch.ops.cuda import nn_kernel  # noqa: E402


SLICES = [1, 2, 4, 8, 16]   # × 32 source tiles = blocks at the ICP shape
SHAPES = [(4096, 16384), (4096, 32768), (4096, 65536), (8192, 16384),
          (1024, 16384), (4096, 4096)]
PTR, I32 = ctypes.c_void_p, ctypes.c_int


def load():
    lib_path, _secs, log = nn_kernel.build()
    lib = ctypes.CDLL(str(lib_path))
    lib.nn_launch.argtypes = [PTR, PTR, PTR, I32, I32, I32, I32,
                              PTR, PTR, PTR, PTR, PTR]
    lib.nn_launch_simple.argtypes = [PTR, PTR, PTR, I32, I32, PTR, PTR, PTR]
    regs = [int(line.split("Used ")[1].split(" registers")[0])
            for line in log.splitlines() if "Used " in line]
    return lib, lib_path, regs


def graph_ms(fn, calls=50, replays=10):
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


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(7)
    data = {}
    for n, m in SHAPES:
        data[n, m] = (
            torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 30).to(dev),
            torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32) * 30).to(dev),
            torch.ones(m, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty((64, n), dtype=torch.float32, device=dev),
            torch.empty((64, n), dtype=torch.int32, device=dev))

    lib, lib_path, regs = load()

    def launcher(n, m, slices=None):
        """One launch of the kernel at that many slices, or of the first
        version where `slices` is None."""
        s, t, k, idx, d2, sd, sj = data[n, m]
        if slices is None:
            return lambda: lib.nn_launch_simple(
                s.data_ptr(), t.data_ptr(), k.data_ptr(), n, m,
                idx.data_ptr(), d2.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        sub_len = -(-m // (slices * nn_kernel.SUB_SLICES))
        sub_len = -(-sub_len // nn_kernel.ROUND) * nn_kernel.ROUND
        return lambda: lib.nn_launch(
            s.data_ptr(), t.data_ptr(), k.data_ptr(), n, m, slices, sub_len,
            idx.data_ptr(), d2.data_ptr(), sd.data_ptr(), sj.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    n, m = SHAPES[0]
    idx, d2 = data[n, m][3:5]
    if launcher(n, m)() != 0:
        raise RuntimeError("the first version's launch failed")
    torch.cuda.synchronize()
    want = idx.clone(), d2.clone()
    for slices in SLICES:
        idx.zero_(), d2.zero_()
        rc = launcher(n, m, slices)()
        torch.cuda.synchronize()
        equal = rc == 0 and torch.equal(idx, want[0]) and torch.equal(d2, want[1])
        o1 = graph_ms(launcher(n, m))
        k1 = graph_ms(launcher(n, m, slices))
        k2 = graph_ms(launcher(n, m, slices))
        print(json.dumps({"slices": slices,
                          "blocks": -(-n // nn_kernel.SRC_TILE) * slices,
                          "planned": slices == nn_kernel.plan(n, m, sms)[1],
                          "rc": rc, "bit_equal": equal, "registers": regs,
                          "ms": [k1, k2], "simple_ms": o1}), flush=True)

    fn = launcher(n, m, nn_kernel.plan(n, m, sms)[1])
    for _ in range(20000):  # ~0.8 s of queued work
        fn()
    print("under load: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.cuda.synchronize()
    for sn, sm_ in SHAPES[1:]:
        slices = nn_kernel.plan(sn, sm_, sms)[1]
        ms = graph_ms(launcher(sn, sm_, slices))
        print(json.dumps({"shape": [sn, sm_], "slices": slices, "ms": ms,
                          "ns_per_kpair": 1e9 * ms / (sn * sm_)}))
    if "--sass" in sys.argv[1:]:
        out = sys.argv[sys.argv.index("--sass") + 1]
        cuobjdump = os.path.join(os.path.dirname(nn_kernel._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=False)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(sass.stdout + sass.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
