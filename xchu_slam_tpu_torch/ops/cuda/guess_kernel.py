"""The device engine's external NDT guess on the card: the CUDA kernel
`csrc/guess_kernel.cu`, one launch of one warp a scan (lane 0 the IMU chain,
lane 1 the wheel chain).

`ops/imu.py::ext_guess` routes CUDA tensors here; its plain PyTorch version
is `ops/imu.py::ext_guess_ref`. The functions here take CUDA tensors only:
they launch or raise, never fall back, never synchronise, and go to
PyTorch's current stream (the capturing stream under a CUDA graph capture:
the device engine captures the guess into Part A's graph). The library is
compiled by nvcc from the repository's source at first use, with
`-fmad=false`, so that the chains keep the plain version's order of
operations.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "guess_kernel.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "-fmad=false")
MAX_SAMPLES = 512    # 16 floats a sample of shared memory: 32 KB

# launches since the last reset. A call recorded into a CUDA graph launches
# nothing: whoever captures takes it off the count again and adds what each
# replay launches (`DeviceSlamPipeline._capture`, `_run_part_a`)
launches = 0


def build() -> tuple[Path, float, str]:
    """Compile `csrc/guess_kernel.cu` unless its library exists. Returns
    (library path, build seconds, nvcc output with ptxas's figures)."""
    return _build.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.guess_launch.argtypes = [ptr] * 10 + [i32] * 3 + [ptr] * 4
    lib.guess_launch.restype = i32
    lib.guess_probe_launch.argtypes = [i32, i32, i32, ptr, ptr]
    lib.guess_probe_launch.restype = i32
    return lib


def _window(win, m_ref: list, dev, name: str):
    """The window's four pointers (stamps, rates, vectors, mask) after the
    checks; `win` is an ImuWindow (stamps, gyro, accel, mask) or an
    OdomWindow (stamps, linear, angular, mask)."""
    if win is None:
        raise ValueError(f"the guess kernel's {name} mode is on and its window is None")
    stamps, mask = win.stamps, win.mask
    rate, vec = (win.gyro, win.accel) if name == "imu" else (win.angular, win.linear)
    m = stamps.shape[0]
    for t, want, shape in ((stamps, torch.float32, (m,)), (rate, torch.float32, (m, 3)),
                           (vec, torch.float32, (m, 3)), (mask, torch.bool, (m,))):
        if t.device != dev:
            raise ValueError(f"the guess kernel takes CUDA tensors on one device, got "
                             f"{t.device} in the {name} window")
        if t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} window: expected contiguous {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    m_ref.append(m)
    return [stamps.data_ptr(), rate.data_ptr(), vec.data_ptr(), mask.data_ptr()]


def ext_guess(pose0: torch.Tensor, imu, wheel, imu_vel: torch.Tensor, use_imu: bool,
              use_odom: bool):
    """(delta float32[6], use_ext 0-d bool, imu_vel float32[3]) of one scan,
    as new tensors on pose0's device: `ops/imu.py::ext_guess_ref`'s function
    by one kernel launch. A window is used only where its mode is on."""
    global launches
    dev = pose0.device
    if dev.type != "cuda" or imu_vel.device != dev:
        raise ValueError("the guess kernel takes CUDA tensors on one device, got "
                         f"{pose0.device} and {imu_vel.device}")
    for name, t, n in (("pose0", pose0, 6), ("imu_vel", imu_vel, 3)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 ({n},)")
    m_ref: list[int] = []
    ptrs = (_window(imu, m_ref, dev, "imu") if use_imu else [None] * 4) \
        + (_window(wheel, m_ref, dev, "wheel") if use_odom else [None] * 4)
    m = m_ref[0] if m_ref else 1
    if any(x != m for x in m_ref) or not 1 <= m <= MAX_SAMPLES:
        raise ValueError(f"the guess kernel takes windows of one length in [1, "
                         f"{MAX_SAMPLES}], got {m_ref}")
    delta = torch.empty(6, device=dev)
    use_ext = torch.empty((), dtype=torch.bool, device=dev)
    vel = torch.empty(3, device=dev)
    rc = _library().guess_launch(pose0.data_ptr(), imu_vel.data_ptr(), *ptrs, m, int(use_imu),
                                 int(use_odom), delta.data_ptr(), use_ext.data_ptr(),
                                 vel.data_ptr(), _build.raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"guess_kernel launch failed: CUDA error {rc}")
    launches += 1
    return delta, use_ext, vel


PROBES = {"launch": 0, "chain": 1}


def probe(kind: str, reps: int, m: int, out: torch.Tensor) -> None:
    """One launch of the source's probe kernel (1 × 32 threads, the kernel's
    geometry): `launch` returns at once, `chain` runs `reps` dependent chains
    of m samples in lanes 0-1 from out[0] and writes out[0:2]. Not counted in
    `launches`; nothing on a main path calls it."""
    if out.device.type != "cuda" or out.dtype != torch.float32 or out.numel() < 2:
        raise ValueError("probe: out must be a CUDA float32 tensor of ≥ 2 entries")
    rc = _library().guess_probe_launch(PROBES[kind], reps, m, out.data_ptr(),
                                       _build.raw_stream(out.device.index))
    if rc != 0:
        raise RuntimeError(f"guess_kernel {kind} probe launch failed: CUDA error {rc}")
