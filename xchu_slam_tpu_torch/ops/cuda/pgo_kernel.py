"""The pose-graph PCG on the card: the CUDA kernel `csrc/pgo_kernel.cu`.

One launch is the linear solve of one Gauss-Newton iteration: the chain
preconditioner's block-LDLᵀ factorisation, then the PCG loop with its stop
test `rz > cg_tol·rz0 && it < cg_iterations` decided in the kernel, one block
of 384 threads, nothing read back. Its plain PyTorch version is the factor,
substitutions and CG loop of `models/pose_graph.py::solve_ref`, which takes
CPU tensors; `pose_graph.solve` comes here for CUDA tensors, from both
engines. `cg` takes CUDA tensors only: it launches the kernel or raises,
never falls back, never synchronises, and goes to PyTorch's current stream.
The library is compiled by nvcc from the repository's source at first use.

The kernel's first version (`csrc/pgo_kernel_first.cu`, `_cg_first`) stays
as the yardstick the redesign is timed against; only `chip_smoke.py`, the
card tests and `tools/torch_loop_phase_probe.py` launch it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "pgo_kernel.cu"
_SRC_FIRST = _build.CSRC / "pgo_kernel_first.cu"
NVCC_FLAGS = _build.BASE_FLAGS
THREADS = 384   # csrc/pgo_kernel.cu: kThreads
MAX_KEYFRAMES, MAX_LOOPS = 4096, 256   # kMaxK, kMaxL: the slots its shared memory holds

# kernel launches since the last reset (one per Gauss-Newton iteration of a
# solve on the card; read and reset by callers that need to show it ran)
launches = 0


def build() -> tuple[Path, float, str]:
    """Compile `csrc/pgo_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


def build_first() -> tuple[Path, float, str]:
    """Compile `csrc/pgo_kernel_first.cu`, the kernel's first version."""
    return _build.build(_SRC_FIRST, NVCC_FLAGS)


_CG_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_int] + [ctypes.c_void_p] * 4


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pgo_cg_launch.argtypes = _CG_ARGTYPES
    lib.pgo_cg_launch.restype = i32
    lib.pgo_cg_launch_sweep.argtypes = _CG_ARGTYPES + [i32]
    lib.pgo_cg_launch_sweep.restype = i32
    lib.pgo_scratch_floats.argtypes = [i32, i32]
    lib.pgo_scratch_floats.restype = ctypes.c_longlong
    lib.pgo_probe_launch.argtypes = [i32, i32, i32, ptr, ptr]
    lib.pgo_probe_launch.restype = i32
    if (lib.pgo_threads(), lib.pgo_max_keyframes(), lib.pgo_max_loops()) != \
            (THREADS, MAX_KEYFRAMES, MAX_LOOPS):
        raise RuntimeError("pgo_kernel.cu and its wrapper disagree on the geometry")
    return lib


@functools.lru_cache(maxsize=1)
def _library_first() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_first()[0]))
    lib.pgo_cg_first_launch.argtypes = _CG_ARGTYPES
    lib.pgo_cg_first_launch.restype = ctypes.c_int
    lib.pgo_first_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pgo_first_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(named: dict, K: int, L: int):
    shapes = {"D": (K, 6, 6), "U": (K, 6, 6), "g": (K, 6), "Ji": (K, 6, 6),
              "Jj": (K, 6, 6), "oinfo": (6,), "wp": (K,), "Jli": (L, 6, 6),
              "Jlj": (L, 6, 6), "li": (L,), "lj": (L,), "wl": (L,), "gA": (K, 3),
              "gz": (K,), "kf": (K,), "run": ()}
    dev = named["D"].device
    if dev.type != "cuda" or any(t.device != dev for t in named.values()):
        raise ValueError("the PGO kernel takes CUDA tensors on one device, got "
                         f"{sorted({str(t.device) for t in named.values()})}")
    for name, t in named.items():
        want = (torch.int64 if name in ("li", "lj") else
                torch.bool if name in ("kf", "run") else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("U", "Ji", "Jj") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernel reads its "
                             "blocks as float4)")
    if not 2 <= K <= MAX_KEYFRAMES or L > MAX_LOOPS:
        raise ValueError(f"the PGO kernel takes 2-{MAX_KEYFRAMES} keyframe slots and at "
                         f"most {MAX_LOOPS} loop slots, got {K} and {L}")


def _launch(launch, scratch_floats, named: dict, cg_tol: float, cg_iterations: int,
            *extra):
    K, L = named["D"].shape[0], named["Jli"].shape[0]
    _check(named, K, L)
    dev = named["D"].device
    x = torch.empty((K, 6), dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(scratch_floats(K, L)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(*(t.data_ptr() for t in named.values()), K, L, float(cg_tol),
                    int(cg_iterations), x.data_ptr(), iters.data_ptr(), scratch.data_ptr(),
                    _build.raw_stream(dev.index), *extra)
    if rc != 0:
        raise RuntimeError(f"pgo_kernel launch failed: CUDA error {rc}")
    return x, iters


def cg(D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
       cg_tol: float, cg_iterations: int):
    """The update x [K,6] (0 on node 0, on dead keyframes and everywhere when
    `run` is false) and the CG trip count (int32 [1]) of one Gauss-Newton
    iteration, both on the card. Arguments as `pose_graph.solve`'s
    `_gn_system` assembles them."""
    global launches
    named = dict(D=D, U=U, g=g, Ji=Ji, Jj=Jj, oinfo=oinfo, wp=wp, Jli=Jli, Jlj=Jlj,
                 li=li, lj=lj, wl=wl, gA=gA, gz=gz, kf=kf, run=run)
    lib = _library()
    out = _launch(lib.pgo_cg_launch, lib.pgo_scratch_floats, named, cg_tol, cg_iterations)
    launches += 1
    return out


def _cg_sweep(D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
              cg_tol: float, cg_iterations: int, seg_min: int):
    """`cg` with the substitutions segmented from `seg_min` coupled keyframes
    on (the kernel's own choice is its constant kSegmentedMin): 0 forces the
    segmented sweeps, a number past K the sequential ones. For timings and
    tests only: not counted in `launches`."""
    named = dict(D=D, U=U, g=g, Ji=Ji, Jj=Jj, oinfo=oinfo, wp=wp, Jli=Jli, Jlj=Jlj,
                 li=li, lj=lj, wl=wl, gA=gA, gz=gz, kf=kf, run=run)
    lib = _library()
    return _launch(lib.pgo_cg_launch_sweep, lib.pgo_scratch_floats, named, cg_tol,
                   cg_iterations, int(seg_min))


def _cg_first(D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
              cg_tol: float, cg_iterations: int):
    """`cg` by the kernel's first version (`csrc/pgo_kernel_first.cu`), for
    comparisons only: not counted in `launches`."""
    named = dict(D=D, U=U, g=g, Ji=Ji, Jj=Jj, oinfo=oinfo, wp=wp, Jli=Jli, Jlj=Jlj,
                 li=li, lj=lj, wl=wl, gA=gA, gz=gz, kf=kf, run=run)
    lib = _library_first()
    return _launch(lib.pgo_cg_first_launch, lib.pgo_first_scratch_floats, named, cg_tol,
                   cg_iterations)


PROBES = {"launch": 0, "barrier": 1, "sweep_link": 2, "factor_link": 3,
          "factor_link_columns": 4, "segment_link": 5, "factor_link_lane0": 6}


def probe(kind: str, reps: int, out: torch.Tensor, threads: int = THREADS) -> None:
    """One launch of the source's probe kernel on PyTorch's current stream
    (`PROBES`: an empty launch, `reps` block barriers of `threads` threads,
    `reps` links of the sequential substitution, of the first version's
    factor recursion, of this kernel's factor link with its Cholesky across
    six lanes or in lane 0, or of a segment lane's substitution). Not counted in `launches`; nothing on a
    main path calls it."""
    dev = out.device
    rc = _library().pgo_probe_launch(PROBES[kind], reps, threads, out.data_ptr(),
                                     _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"pgo_kernel {kind} probe failed: CUDA error {rc}")
