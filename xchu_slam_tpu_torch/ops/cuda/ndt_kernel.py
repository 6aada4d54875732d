"""NDT alignment with its Newton and line-search loops on the card: the
CUDA kernel `csrc/ndt_kernel.cu`.

The reference leaves this work to XLA (`xchu_slam_tpu/ops/ndt.py::
newton_align` under two `lax.while_loop`s); there is no TPU kernel to
replace. The kernel's plain PyTorch version is `ops/ndt.py::align_ref`,
which `ndt.align` takes for CPU tensors; for CUDA tensors `ndt.align` comes
here, from both engines. The functions here take CUDA tensors only: they
launch the kernel or raise, never fall back, never synchronise, and go to
PyTorch's current stream (the capturing stream under a CUDA graph capture).

One cooperative launch is one whole align: `align_record` returns the
kernel's 64-float record on the card (`RECORD` names its slots).
`hessian_pass` runs the kernel's single-pass mode: (L, g, H) at a pose.
`shard_pass` launches the source's second kernel, the pass of a sharded
align (`ops/ndt.py::align` with a mesh), whose Newton and line-search control
runs on the host from the sums every rank reduces: one pass over a shard's
pairs at an evaluation pose on the neighbourhood gathered at a second pose,
its 32 fixed-order sums (the 28 of (L, g, H) or (L, g), and the fitness
sums at 28-30). Its plain version is `ops/ndt_deriv.py`'s pass on the
shard.
The kernel has one instantiation per neighbourhood size and line search
(`NdtSpec.neighbor_mode` × `ls_mode`: DIRECT1, DIRECT7 (and direct7_rows,
the same voxels) or the 27-cube of DIRECT26 / KDTREE, × backtrack,
mt_exact, ref_clamped); the spec picks it. `NdtSpec.regather_dist` is a
launch argument of every instantiation: the kernel gathers the
neighbourhood again only where the pose has moved more than it since the
last gather (`ops/ndt.py::newton_align`'s rule).
`plan` is the launch geometry: a lane per (point, neighbour) pair, `LANES`
lanes a point (1, 8 or 32), one block of 512 threads an SM. `probe`
launches the source's probe kernels, which time what an align waits for (a
launch, a barrier, a round trip to L2, the control step); nothing on a main
path calls it. The library is compiled by nvcc from the repository's source
at first use, with `-fmad=false` so that the control thresholds are compared
as the plain version compares them.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops import voxel_map as vm
from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "ndt_kernel.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false")

# the kernel's geometry (csrc/ndt_kernel.cu: kThreads, kAcc, kRow, kOut, and
# Neighbours<M>: kLanes, kCacheTrips)
THREADS = 512
# voxels a point, by neighbour mode; the lanes that own one source point (its
# voxels and idle lanes up to a power of two), and the trips of the
# grid-stride loop over which the kernel keeps the gathered rows in shared
# memory (past them it gathers again every pass)
NEIGHBOURS = vm.NEIGHBOR_COUNT
LANES = {"direct1": 1, "direct7": 8, "direct7_rows": 8, "direct26": 32, "kdtree": 32}
CACHE_TRIPS = {"direct1": 1, "direct7": 1, "direct7_rows": 1, "direct26": 4, "kdtree": 4}
LINE_SEARCHES = {"backtrack": 0, "mt_exact": 1, "ref_clamped": 2}
ACC = 28
ROW = 32        # floats of one block's partial
OUT = 64
# slots of the result record
RECORD = {"pose": slice(0, 6), "iterations": 6, "converged": 7, "score": 8,
          "matched_frac": 9, "fitness": 10, "trials": 11, "L": 12,
          "g": slice(13, 19), "H": slice(19, 55), "passes": 55}

# kernel launches since the last reset (read and reset by callers that need
# to show the kernel ran): the host engine's eager launch a scan counts here
# as it is made. A call recorded into a CUDA graph launches
# nothing: whoever captures takes it off the count again and adds what each
# replay launches (`DeviceSlamPipeline._capture`, `_run_part_a`)
launches = 0
# launches of the shard pass (`shard_pass`), counted apart
pass_launches = 0
PASS_KINDS = {"hessian": 0, "gradient": 1, "fitness": 2}


def build() -> tuple[Path, float, str]:
    """Compile `csrc/ndt_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ndt_align_launch.argtypes = ([ptr] * 7 + [i32] * 4 + [f32] * 7 + [i32] * 7
                                     + [f32] * 2 + [ptr])
    lib.ndt_align_launch.restype = i32
    lib.ndt_max_blocks.argtypes = [i32] * 3
    lib.ndt_max_blocks.restype = i32
    lib.ndt_pass_launch.argtypes = [ptr] * 7 + [i32] * 4 + [f32] * 5 + [i32] * 4 + [f32, ptr]
    lib.ndt_pass_launch.restype = i32
    lib.ndt_pass_max_blocks.argtypes = [i32] * 2
    lib.ndt_pass_max_blocks.restype = i32
    lib.ndt_probe_max_clusters.argtypes = [i32, i32]
    lib.ndt_probe_max_clusters.restype = i32
    lib.ndt_probe_launch.argtypes = [i32] * 4 + [ptr] * 2 + [f32] * 2 + [ptr]
    lib.ndt_probe_launch.restype = i32
    geometry = [i32() for _ in range(4)]
    lib.ndt_geometry(*(ctypes.byref(v) for v in geometry))
    lanes, trips = i32(), i32()
    per_mode = {}
    for mode, m in NEIGHBOURS.items():
        lib.ndt_neighbours(m, ctypes.byref(lanes), ctypes.byref(trips))
        per_mode[mode] = (lanes.value, trips.value)
    if tuple(v.value for v in geometry) != (THREADS, ACC, ROW, OUT) or per_mode != {
            mode: (LANES[mode], CACHE_TRIPS[mode]) for mode in NEIGHBOURS}:
        raise RuntimeError("ndt_kernel.cu and its wrapper disagree on the geometry")
    return lib


def plan(n: int, sms: int, lanes: int = LANES["direct7"]) -> tuple[int, int]:
    """(blocks, trips) of one launch for `n` source points of `lanes` lanes
    each where the card holds `sms` blocks of the kernel at once (one an SM).
    A block covers THREADS / lanes points a trip of its grid-stride loop; the
    blocks are the fewest that keep the trips at their least, so no block
    idles a whole trip and the barrier has no more arrivals than it needs."""
    if n < 1 or sms < 1:
        raise ValueError(f"plan needs n >= 1 and sms >= 1, got {n}, {sms}")
    needed = -(-n * lanes // THREADS)
    trips = -(-needed // sms)
    return -(-needed // trips), trips


@functools.lru_cache(maxsize=32)
def max_blocks(device_index: int, neighbor_mode: str = "direct7",
               ls_mode: str = "backtrack") -> int:
    """Blocks of the mode's kernel instantiation that the device holds at
    once: the most a cooperative launch may ask for."""
    with torch.cuda.device(device_index):
        n = _library().ndt_max_blocks(device_index, NEIGHBOURS[neighbor_mode],
                                      LINE_SEARCHES[ls_mode])
    if n < 1:
        raise RuntimeError("the device cannot launch the NDT kernel cooperatively")
    return n


@functools.lru_cache(maxsize=8)
def pass_max_blocks(device_index: int, neighbor_mode: str = "direct7") -> int:
    """Blocks of the shard pass for the mode that the device holds at once."""
    with torch.cuda.device(device_index):
        n = _library().ndt_pass_max_blocks(device_index, NEIGHBOURS[neighbor_mode])
    if n < 1:
        raise RuntimeError("the device cannot launch the NDT shard pass cooperatively")
    return n


def check_modes(nspec) -> None:
    """Raise on a spec that has no kernel instantiation (and that the plain
    version does not run either), naming what is refused."""
    if nspec.max_iterations < 1:
        raise ValueError("NdtSpec.max_iterations must be >= 1")
    if nspec.ls_mode not in LINE_SEARCHES:
        raise ValueError(f"unknown ls_mode {nspec.ls_mode!r}; the port runs "
                         f"{tuple(LINE_SEARCHES)}")
    if nspec.neighbor_mode not in NEIGHBOURS:
        raise ValueError(f"unknown neighbor_mode {nspec.neighbor_mode!r}; the port runs "
                         f"{tuple(NEIGHBOURS)}")


def _check(fin, origin, src, mask, pose, gspec):
    tensors = (fin, origin, src, mask, pose)
    if any(t.device != fin.device for t in tensors) or fin.device.type != "cuda":
        raise ValueError("the NDT kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in (fin, origin, src, pose)) \
            or mask.dtype != torch.bool:
        raise TypeError("expected float32 fin/origin/src/pose and a bool mask")
    n = src.shape[0]
    if fin.shape != (gspec.num_voxels, 10) or origin.shape != (3,) \
            or src.shape != (n, 3) or mask.shape != (n,) or pose.shape != (6,) or n < 1:
        raise ValueError(f"bad shapes {tuple(fin.shape)} {tuple(origin.shape)} "
                         f"{tuple(src.shape)} {tuple(mask.shape)} {tuple(pose.shape)}")
    if not all(t.is_contiguous() for t in tensors) or fin.data_ptr() % 8:
        raise ValueError("the NDT kernel takes contiguous tensors (fin 8-byte aligned)")


def _launch(fin, origin, src, mask, pose, gspec, nspec, d1: float, d2: float,
            mode: int) -> torch.Tensor:
    _check(fin, origin, src, mask, pose, gspec)
    check_modes(nspec)
    dev = src.device
    lib = _library()
    nb = nspec.neighbor_mode
    blocks, _trips = plan(src.shape[0], max_blocks(dev.index, nb, nspec.ls_mode), LANES[nb])
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    partial = torch.empty(2 * blocks * ROW, dtype=torch.float32, device=dev)
    s = -0.5 * d2
    with torch.cuda.device(dev):
        rc = lib.ndt_align_launch(
            src.data_ptr(), mask.data_ptr(), fin.data_ptr(), origin.data_ptr(),
            pose.data_ptr(), out.data_ptr(), partial.data_ptr(),
            src.shape[0], gspec.gx, gspec.gy, gspec.gz,
            gspec.resolution, d1, s, 2.0 * s, 4.0 * s * s,
            nspec.step_size, nspec.trans_eps,
            nspec.max_iterations, nspec.ls_max_trials, mode, blocks,
            NEIGHBOURS[nb], LINE_SEARCHES[nspec.ls_mode], int(nb == "kdtree"),
            gspec.resolution ** 2, nspec.regather_dist, _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"ndt_kernel launch failed: CUDA error {rc}")
    return out


def align_record(fin, origin, src, mask, init_pose, gspec, nspec,
                 d1: float, d2: float) -> torch.Tensor:
    """One whole align on the card. Returns the kernel's record, float32[64]
    on the device (see `RECORD`); nothing is read back."""
    global launches
    out = _launch(fin, origin, src, mask, init_pose, gspec, nspec, d1, d2, mode=0)
    launches += 1
    return out


def hessian_pass(fin, origin, src, mask, pose, gspec, nspec, d1: float, d2: float):
    """(L, g [6], H [6,6]) of one score / gradient / Hessian pass at `pose`,
    through the kernel's single-pass mode. Not counted in `launches`."""
    out = _launch(fin, origin, src, mask, pose, gspec, nspec, d1, d2, mode=1)
    return out[RECORD["L"]], out[RECORD["g"]], out[RECORD["H"]].reshape(6, 6)


def shard_pass(fin, origin, src, mask, pose, ctx_pose, gspec, nspec, d1: float, d2: float,
               kind: str) -> torch.Tensor:
    """One pass of a sharded align over `src` (this rank's shard): the pairs
    evaluated at `pose` on the neighbourhood gathered at `ctx_pose`, both
    float32[6] on the card. Returns its 32 fixed-order sums, float32[32] on
    the card: for `kind` "hessian" L, Σc·a6 (g / 2s) and the upper triangle
    of H (0-27); "gradient" L and Σc·a6 (0-6) and the fitness sums; "fitness"
    the fitness sums alone (28: matched points, 29: Σ min d², 30: points).
    Counted in `pass_launches`."""
    global pass_launches
    _check(fin, origin, src, mask, pose, gspec)
    if ctx_pose.shape != (6,) or ctx_pose.device != pose.device \
            or ctx_pose.dtype != torch.float32:
        raise ValueError("ctx_pose must be float32[6] on the pose's device")
    check_modes(nspec)
    dev = src.device
    nb = nspec.neighbor_mode
    blocks, _trips = plan(src.shape[0], pass_max_blocks(dev.index, nb), LANES[nb])
    poses = torch.cat([pose, ctx_pose])
    out = torch.empty(ROW, dtype=torch.float32, device=dev)
    partial = torch.empty(blocks * ROW, dtype=torch.float32, device=dev)
    s = -0.5 * d2
    with torch.cuda.device(dev):
        rc = _library().ndt_pass_launch(
            src.data_ptr(), mask.data_ptr(), fin.data_ptr(), origin.data_ptr(),
            poses.data_ptr(), out.data_ptr(), partial.data_ptr(),
            src.shape[0], gspec.gx, gspec.gy, gspec.gz,
            gspec.resolution, d1, s, 2.0 * s, 4.0 * s * s,
            PASS_KINDS[kind], blocks, NEIGHBOURS[nb], int(nb == "kdtree"),
            gspec.resolution ** 2, _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"ndt_kernel shard pass launch failed: CUDA error {rc}")
    pass_launches += 1
    return out


PROBES = {"grid": 0, "cluster": 1, "chase": 2, "control": 3}


def probe_max_clusters(cluster: int, threads: int) -> int:
    """Clusters of `cluster` blocks × `threads` threads of the cluster probe
    that the current device holds at once; 0 where one cannot be placed."""
    n = _library().ndt_probe_max_clusters(cluster, threads)
    if n < 0:
        raise RuntimeError("the device refused the cluster occupancy query")
    return n


def probe(kind: str, reps: int, blocks: int = 1, threads: int = 32, inp=None, out=None,
          two_s: float = 0.0, step_size: float = 0.0) -> None:
    """One launch of a probe kernel on PyTorch's current stream. `grid`:
    `reps` grid barriers on a cooperative launch of blocks × threads;
    `cluster`: `reps` cluster barriers on one cluster of `blocks` blocks;
    `chase`: `reps` dependent L2 loads through `inp` (int32 next-index table)
    in one thread, the last index to `out`; `control`: `reps` control steps
    of a Hessian pass on the 28 sums at `inp` in one warp, the trial step to
    `out` (float32[6]). Not counted in `launches`."""
    dev = torch.cuda.current_device()
    rc = _library().ndt_probe_launch(
        PROBES[kind], blocks, threads, reps,
        None if inp is None else inp.data_ptr(), None if out is None else out.data_ptr(),
        two_s, step_size, _build.raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"ndt_kernel {kind} probe failed: CUDA error {rc}")
