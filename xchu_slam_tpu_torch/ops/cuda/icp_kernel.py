"""One ICP iteration's update on the card: the CUDA kernel
`csrc/icp_kernel.cu` (`icp_step`), with the verification's set-up and final
fitness entries of the same source.

`ops/icp.py::align` strings these with the NN kernel into one CUDA graph per
(N, M, spec) and replays it: max_iterations × (NN, `step`) plus the fitness
pass, a `live` flag in the state ending the loop on the card. The plain
PyTorch version is `ops/icp.py::align_ref`. The functions here take CUDA
tensors only: they launch or raise, never fall back, never synchronise, and
go to PyTorch's current stream (the capturing stream under a CUDA graph
capture). The library is compiled by nvcc from the repository's source at
first use.

For a verification whose source is sharded over a mesh of ranks
(`ops/icp.py::align` with `mesh`), `partial` and `solve` are `step` cut at its
reductions: `partial` stage 0 gives the shard's 8 first-pass sums, stage 1
its 9 centred sums about the means of the reduced 8, and `solve` does the
rest of the step from the reduced 17 (the rotation, the update, the stop
tests, the shard's next `cur`), in `step`'s arithmetic, so that a mesh of one
rank reproduces `step` bit for bit. Their plain versions are
`ops/icp.py::_shard_moments` and the host update of `align_ref`.

The state is float32[24] on the card (`STATE` names its slots). The step
kernel's first version (`csrc/icp_kernel_first.cu`, `_step_first`, the same
state) stays as the yardstick the redesign is timed against; only
`chip_smoke.py`, the card tests and `tools/torch_loop_phase_probe.py` launch
it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "icp_kernel.cu"
_SRC_FIRST = _build.CSRC / "icp_kernel_first.cu"
NVCC_FLAGS = _build.BASE_FLAGS
STATE_FLOATS = 24
STATE = {"T": slice(0, 16), "iterations": 16, "converged": 17, "prev_err": 18,
         "live": 19, "fitness": 20, "live0": 21}

# launches of the step kernel since the last reset. A call recorded into a
# CUDA graph launches nothing: whoever captures takes it off the count again
# and adds what each replay launches (`ops/icp.py::_IcpGraph`)
launches = 0
# launches of the split step's two entries (`partial`, `solve`), counted apart
partial_launches = 0
solve_launches = 0
PARTIAL_FLOATS = (8, 9)        # the sums of stage 0 and of stage 1
SUMS = 17


def build() -> tuple[Path, float, str]:
    """Compile `csrc/icp_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


def build_first() -> tuple[Path, float, str]:
    """Compile `csrc/icp_kernel_first.cu`, the step kernel's first version."""
    return _build.build(_SRC_FIRST, NVCC_FLAGS)


_STEP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _library_first() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_first()[0]))
    lib.icp_step_first_launch.argtypes = _STEP_ARGTYPES
    lib.icp_step_first_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icp_init_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr]
    lib.icp_init_launch.restype = i32
    lib.icp_step_launch.argtypes = _STEP_ARGTYPES
    lib.icp_step_launch.restype = i32
    lib.icp_fitness_launch.argtypes = [ptr, i32, ptr, ptr, f32, ptr]
    lib.icp_partial_launch.argtypes = [ptr, ptr, i32] + [ptr] * 6 + [f32, i32, ptr]
    lib.icp_partial_launch.restype = i32
    lib.icp_solve_launch.argtypes = [ptr, i32, ptr, ptr, ptr, f32, i32, ptr]
    lib.icp_solve_launch.restype = i32
    lib.icp_fitness_launch.restype = i32
    lib.icp_probe_launch.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.icp_probe_launch.restype = i32
    if lib.icp_state_floats() != STATE_FLOATS:
        raise RuntimeError("icp_kernel.cu and its wrapper disagree on the state")
    return lib


def _check(**named):
    dev = next(iter(named.values())).device
    if dev.type != "cuda" or any(t.device != dev for t in named.values()):
        raise ValueError("the ICP kernel takes CUDA tensors on one device, got "
                         f"{sorted({str(t.device) for t in named.values()})}")
    for name, t in named.items():
        want = torch.bool if name in ("src_mask", "live") else \
            torch.int32 if name == "idx" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"icp_kernel {what} launch failed: CUDA error {rc}")


def init(src, init_T, live, st, cur) -> None:
    """st ← the initial state at `init_T` [4,4] with `live` (0-d bool) as
    its flag; cur [N,3] ← init_T · src. Not counted in `launches`."""
    dev = _check(src=src, init_T=init_T, live=live, st=st, cur=cur)
    n = src.shape[0]
    if init_T.shape != (4, 4) or st.shape != (STATE_FLOATS,) or cur.shape != (n, 3) \
            or src.shape != (n, 3) or live.numel() != 1:
        raise ValueError("bad shapes for icp_kernel.init")
    _rc(_library().icp_init_launch(src.data_ptr(), n, init_T.data_ptr(), live.data_ptr(),
                                   st.data_ptr(), cur.data_ptr(),
                                   _build.raw_stream(dev.index)), "init")


def _step(launch, src, src_mask, tgt, idx, d2, cur, st, max_d2, trans_eps,
          max_iterations) -> None:
    dev = _check(src=src, src_mask=src_mask, tgt=tgt, idx=idx, d2=d2, cur=cur, st=st)
    n = src.shape[0]
    if src_mask.shape != (n,) or idx.shape != (n,) or d2.shape != (n,) \
            or cur.shape != (n, 3) or tgt.ndim != 2 or tgt.shape[1] != 3 \
            or st.shape != (STATE_FLOATS,):
        raise ValueError("bad shapes for icp_kernel.step")
    _rc(launch(src.data_ptr(), src_mask.data_ptr(), n, tgt.data_ptr(), idx.data_ptr(),
               d2.data_ptr(), cur.data_ptr(), st.data_ptr(), max_d2, trans_eps,
               max_iterations, _build.raw_stream(dev.index)), "step")


def step(src, src_mask, tgt, idx, d2, cur, st, max_d2: float, trans_eps: float,
         max_iterations: int) -> None:
    """One iteration from the NN kernel's (idx, d2) for `cur` against `tgt`:
    updates st and cur in place; a no-op on the card where st's live flag
    is off."""
    global launches
    _step(_library().icp_step_launch, src, src_mask, tgt, idx, d2, cur, st, max_d2,
          trans_eps, max_iterations)
    launches += 1


def _step_first(src, src_mask, tgt, idx, d2, cur, st, max_d2: float, trans_eps: float,
                max_iterations: int) -> None:
    """`step` by the kernel's first version (`csrc/icp_kernel_first.cu`), for
    comparisons only: not counted in `launches`."""
    _step(_library_first().icp_step_first_launch, src, src_mask, tgt, idx, d2, cur, st,
          max_d2, trans_eps, max_iterations)


def fitness(src_mask, d2, st, max_d2: float) -> None:
    """st's fitness slot ← Σ w·d² / max(Σ w, 1) from the NN kernel's d2 at
    the final transform, where the verification ran. Not counted in
    `launches`."""
    dev = _check(src_mask=src_mask, d2=d2, st=st)
    n = src_mask.shape[0]
    if d2.shape != (n,) or st.shape != (STATE_FLOATS,):
        raise ValueError("bad shapes for icp_kernel.fitness")
    _rc(_library().icp_fitness_launch(src_mask.data_ptr(), n, d2.data_ptr(), st.data_ptr(),
                                      max_d2, _build.raw_stream(dev.index)), "fitness")


def partial(src, src_mask, tgt, idx, d2, st, max_d2: float, stage: int,
            sums=None) -> torch.Tensor:
    """The shard's sums of one sharded iteration at st's transform, a new
    float32 tensor on the card: stage 0 the 8 first-pass sums (Σw, Σw·s [3],
    Σw·t [3], Σw·d²), stage 1 the 9 centred sums Σ w (t − μt)(s − μs)ᵀ about
    the means of `sums` (the reduced 8). Counted in `partial_launches`."""
    global partial_launches
    if stage not in (0, 1):
        raise ValueError(f"stage must be 0 or 1, got {stage}")
    if sums is None:
        if stage == 1:
            raise ValueError("stage 1 needs the reduced sums of stage 0")
        sums = st
    dev = _check(src=src, src_mask=src_mask, tgt=tgt, idx=idx, d2=d2, st=st, sums=sums)
    n = src.shape[0]
    if src.shape != (n, 3) or src_mask.shape != (n,) or idx.shape != (n,) \
            or d2.shape != (n,) or tgt.ndim != 2 or tgt.shape[1] != 3 \
            or st.shape != (STATE_FLOATS,) or (stage == 1 and sums.numel() < 8):
        raise ValueError("bad shapes for icp_kernel.partial")
    out = torch.empty(SUMS, dtype=torch.float32, device=dev)
    _rc(_library().icp_partial_launch(src.data_ptr(), src_mask.data_ptr(), n, tgt.data_ptr(),
                                      idx.data_ptr(), d2.data_ptr(), st.data_ptr(),
                                      sums.data_ptr(), out.data_ptr(), max_d2, stage,
                                      _build.raw_stream(dev.index)), "partial")
    partial_launches += 1
    return out[:8] if stage == 0 else out[8:]


def solve(src, sums, st, cur, trans_eps: float, max_iterations: int) -> None:
    """The rest of one sharded iteration from the reduced 17 sums (stage 0's
    8, then stage 1's 9): st updated (transform, counters, stop tests, live
    flag) and cur [n,3] ← T·src for the shard. Counted in `solve_launches`."""
    global solve_launches
    dev = _check(src=src, sums=sums, st=st, cur=cur)
    n = src.shape[0]
    if src.shape != (n, 3) or cur.shape != (n, 3) or sums.shape != (SUMS,) \
            or st.shape != (STATE_FLOATS,):
        raise ValueError("bad shapes for icp_kernel.solve")
    _rc(_library().icp_solve_launch(src.data_ptr(), n, sums.data_ptr(), cur.data_ptr(),
                                    st.data_ptr(), trans_eps, max_iterations,
                                    _build.raw_stream(dev.index)), "solve")
    solve_launches += 1


PROBES = {"launch": 0, "eigen": 1}


def probe(kind: str, reps: int, M: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the source's probe kernel (1 × 512 threads, the step's
    geometry) on PyTorch's current stream: `launch` returns at once, `eigen`
    runs `reps` dependent eigen-solves of the step's on the cross-covariance
    M [3,3] in warp 0 (out[0] keeps the result live, out[1] ← the sweeps of
    the last). Not counted in `launches`; nothing on a main path calls it."""
    dev = _check(M=M, out=out)
    if M.shape != (3, 3) or out.numel() < 2:
        raise ValueError("bad shapes for icp_kernel.probe")
    _rc(_library().icp_probe_launch(PROBES[kind], reps, M.data_ptr(), out.data_ptr(),
                                    _build.raw_stream(dev.index)), f"{kind} probe")
