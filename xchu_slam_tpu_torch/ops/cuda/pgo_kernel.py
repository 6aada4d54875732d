"""The pose-graph PCG on the card: the CUDA kernel `csrc/pgo_kernel.cu`.

One launch is the linear solve of one Gauss-Newton iteration: the chain
preconditioner's block-LDLᵀ factorisation, then the PCG loop with its stop
test `rz > cg_tol·rz0 && it < cg_iterations` decided in the kernel, one block
of 512 threads, nothing read back. Its plain PyTorch version is the factor,
substitutions and CG loop of `models/pose_graph.py::solve_ref`, which takes
CPU tensors; `pose_graph.solve` comes here for CUDA tensors, from both
engines. `cg` takes CUDA tensors only: it launches the kernel or raises,
never falls back, never synchronises, and goes to PyTorch's current stream.
The library is compiled by nvcc from the repository's source at first use.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "pgo_kernel.cu"
NVCC_FLAGS = _build.BASE_FLAGS
THREADS = 512   # csrc/pgo_kernel.cu: kThreads

# kernel launches since the last reset (one per Gauss-Newton iteration of a
# solve on the card; read and reset by callers that need to show it ran)
launches = 0


def build() -> tuple[Path, float, str]:
    """Compile `csrc/pgo_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pgo_cg_launch.argtypes = [ptr] * 16 + [i32, i32, f32, i32] + [ptr] * 4
    lib.pgo_cg_launch.restype = i32
    lib.pgo_scratch_floats.argtypes = [i32, i32]
    lib.pgo_scratch_floats.restype = ctypes.c_longlong
    lib.pgo_probe_launch.argtypes = [i32, i32, i32, ptr, ptr]
    lib.pgo_probe_launch.restype = i32
    if lib.pgo_threads() != THREADS:
        raise RuntimeError("pgo_kernel.cu and its wrapper disagree on the geometry")
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
    if K < 2:
        raise ValueError("the PGO kernel needs at least 2 keyframe slots")


def cg(D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
       cg_tol: float, cg_iterations: int):
    """The update x [K,6] (0 on node 0, on dead keyframes and everywhere when
    `run` is false) and the CG trip count (int32 [1]) of one Gauss-Newton
    iteration, both on the card. Arguments as `pose_graph.solve`'s
    `_gn_system` assembles them."""
    global launches
    named = dict(D=D, U=U, g=g, Ji=Ji, Jj=Jj, oinfo=oinfo, wp=wp, Jli=Jli, Jlj=Jlj,
                 li=li, lj=lj, wl=wl, gA=gA, gz=gz, kf=kf, run=run)
    K, L = D.shape[0], Jli.shape[0]
    _check(named, K, L)
    lib = _library()
    dev = D.device
    x = torch.empty((K, 6), dtype=torch.float32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.pgo_scratch_floats(K, L)), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.pgo_cg_launch(*(t.data_ptr() for t in named.values()), K, L,
                               float(cg_tol), int(cg_iterations), x.data_ptr(),
                               iters.data_ptr(), scratch.data_ptr(),
                               _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"pgo_kernel launch failed: CUDA error {rc}")
    launches += 1
    return x, iters


PROBES = {"launch": 0, "barrier": 1, "sweep_link": 2, "factor_link": 3}


def probe(kind: str, reps: int, out: torch.Tensor, threads: int = THREADS) -> None:
    """One launch of the source's probe kernel on PyTorch's current stream
    (`PROBES`: an empty launch, `reps` block barriers of `threads` threads,
    `reps` links of a substitution chain or of the factor recursion). Not
    counted in `launches`; nothing on a main path calls it."""
    dev = out.device
    rc = _library().pgo_probe_launch(PROBES[kind], reps, threads, out.data_ptr(),
                                     _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"pgo_kernel {kind} probe failed: CUDA error {rc}")
