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

The state is float32[24] on the card (`STATE` names its slots).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "icp_kernel.cu"
NVCC_FLAGS = _build.BASE_FLAGS
STATE_FLOATS = 24
STATE = {"T": slice(0, 16), "iterations": 16, "converged": 17, "prev_err": 18,
         "live": 19, "fitness": 20, "live0": 21}

# launches of the step kernel since the last reset. A call recorded into a
# CUDA graph launches nothing: whoever captures takes it off the count again
# and adds what each replay launches (`ops/icp.py::_IcpGraph`)
launches = 0


def build() -> tuple[Path, float, str]:
    """Compile `csrc/icp_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.icp_init_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr]
    lib.icp_init_launch.restype = i32
    lib.icp_step_launch.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32,
                                    i32, ptr]
    lib.icp_step_launch.restype = i32
    lib.icp_fitness_launch.argtypes = [ptr, i32, ptr, ptr, f32, ptr]
    lib.icp_fitness_launch.restype = i32
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


def step(src, src_mask, tgt, idx, d2, cur, st, max_d2: float, trans_eps: float,
         max_iterations: int) -> None:
    """One iteration from the NN kernel's (idx, d2) for `cur` against `tgt`:
    updates st and cur in place; a no-op on the card where st's live flag
    is off."""
    global launches
    dev = _check(src=src, src_mask=src_mask, tgt=tgt, idx=idx, d2=d2, cur=cur, st=st)
    n = src.shape[0]
    if src_mask.shape != (n,) or idx.shape != (n,) or d2.shape != (n,) \
            or cur.shape != (n, 3) or tgt.ndim != 2 or tgt.shape[1] != 3 \
            or st.shape != (STATE_FLOATS,):
        raise ValueError("bad shapes for icp_kernel.step")
    _rc(_library().icp_step_launch(src.data_ptr(), src_mask.data_ptr(), n, tgt.data_ptr(),
                                   idx.data_ptr(), d2.data_ptr(), cur.data_ptr(),
                                   st.data_ptr(), max_d2, trans_eps, max_iterations,
                                   _build.raw_stream(dev.index)), "step")
    launches += 1


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
