"""Masked brute-force nearest neighbour: the CUDA kernel
`csrc/nn_kernel.cu` and its plain PyTorch version.

Port of `xchu_slam_tpu/ops/pallas/nn_kernel.py::nearest_neighbor`. For each
source point [N,3]: (index of the nearest valid target point [N] int32,
squared distance [N] float32); a row with no valid target gives (0, 1e30).

`nearest_neighbor` sends a CUDA tensor to the kernel and a CPU tensor to
`nearest_neighbor_ref`; it raises on anything it does not take, and never
falls back from the kernel to the plain version. The kernel cuts the targets
into slices (the blocks of one source tile) of 16 sub-slices each (the warps
of one block), and a second small kernel merges the slices' partial results
from a scratch array; `plan` chooses the split from N, M and the card's SM
count. The kernel is compiled by nvcc from the repository's source at
first use, into `build/kernels/` keyed by the source's hash.

`_nearest_neighbor_simple` launches the first version of the kernel, kept in
the same source as an oracle: tests and the smoke run hold the kernel
bit-equal to it. Nothing else calls it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "nn_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernel's geometry (csrc/nn_kernel.cu: kSrcTile, kWarps, kRound)
SRC_TILE = 128      # source points per block
SUB_SLICES = 16     # warps per block, each scanning its own sub-slice
ROUND = 32          # targets a warp stages at a time
MIN_SUB_LEN = 64    # do not cut the targets finer than this per warp
MAX_SLICES = 64     # bounds the scratch array: [2][slices][N] words

# kernel launches since the last reset (read and reset by callers that need
# to show the kernel ran)
launches = 0


@functools.lru_cache(maxsize=64)
def plan(n: int, m: int, sms: int) -> tuple[int, int, int]:
    """(source tiles, slices, sub-slice length) for N sources against M
    targets on a card of `sms` SMs. As many slices as keep the grid (tiles ×
    slices blocks) within one block per SM, while every warp keeps at least
    `MIN_SUB_LEN` targets; the sub-slice length is rounded up to whole
    staging rounds, and slices that the rounding left empty are dropped, so
    slices × SUB_SLICES × length covers M and every slice has targets."""
    tiles = -(-n // SRC_TILE)
    slices = max(1, min(sms // max(tiles, 1), m // (SUB_SLICES * MIN_SUB_LEN),
                        MAX_SLICES))
    sub_len = -(-m // (slices * SUB_SLICES))
    sub_len = -(-sub_len // ROUND) * ROUND
    slices = -(-m // (SUB_SLICES * sub_len))
    return tiles, slices, sub_len


def nearest_neighbor_ref(src: torch.Tensor, tgt: torch.Tensor,
                         tgt_mask: torch.Tensor, chunk: int = 1024):
    """Plain PyTorch version: the expanded form |s|²+|t|²−2s·t for the
    argmin (as the reference's XLA branch, ops/icp.py:69-90), then the exact
    d² = |s − t[idx]|²; rows of `chunk` sources bound the [chunk, M] block."""
    big = 1e30
    tsq = torch.sum(tgt * tgt, dim=-1)
    idx_out, d2_out = [], []
    for i0 in range(0, src.shape[0], chunk):
        rows = src[i0:i0 + chunk]
        d2 = (torch.sum(rows * rows, -1)[:, None] + tsq[None, :]
              - 2.0 * rows @ tgt.T)
        d2 = torch.where(tgt_mask[None, :], d2, big)
        j = torch.argmin(d2, dim=1)
        d2_exact = torch.sum((rows - tgt[j]) ** 2, -1)
        d2_out.append(torch.where(tgt_mask[j], d2_exact, big))
        idx_out.append(j.to(torch.int32))
    return torch.cat(idx_out), torch.cat(d2_out)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NN kernel cannot be built")
    return path


def build() -> tuple[Path, float, str]:
    """Compile `csrc/nn_kernel.cu` unless the library for this source and
    these flags exists. Returns (library path, build seconds, nvcc output);
    the output (ptxas's figures) is kept beside the library, so a build
    that was already there returns it too."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"nn_kernel-{key}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, 0.0, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nn_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                              ptr, ptr, ptr, ptr, ptr]
    lib.nn_launch.restype = i32
    lib.nn_launch_simple.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.nn_launch_simple.restype = i32
    src_tile, sub_slices = i32(), i32()
    lib.nn_geometry(ctypes.byref(src_tile), ctypes.byref(sub_slices))
    if (src_tile.value, sub_slices.value) != (SRC_TILE, SUB_SLICES):
        raise RuntimeError("nn_kernel.cu and its wrapper disagree on the geometry")
    return lib


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(src, tgt, tgt_mask):
    if src.device != tgt.device or src.device != tgt_mask.device:
        raise ValueError("src, tgt and tgt_mask must share one device")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32 \
            or tgt_mask.dtype != torch.bool:
        raise TypeError("expected float32 src/tgt and a bool mask")
    if src.ndim != 2 or src.shape[1] != 3 or tgt.ndim != 2 or tgt.shape[1] != 3 \
            or tgt_mask.shape != (tgt.shape[0],):
        raise ValueError(f"bad shapes {tuple(src.shape)} {tuple(tgt.shape)} "
                         f"{tuple(tgt_mask.shape)}")
    if tgt.shape[0] == 0:
        raise ValueError("empty target cloud")


def _raw_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on that device. PyTorch's
    internal getter costs a third of the public call; where a PyTorch version
    lacks it, the public call gives the same stream."""
    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is not None:
        return getter(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def _launch(src, tgt, tgt_mask, simple: bool):
    """Check, allocate the outputs and launch one of the two kernels on
    PyTorch's current stream."""
    _check(src, tgt, tgt_mask)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if not (src.is_contiguous() and tgt.is_contiguous() and tgt_mask.is_contiguous()):
        raise ValueError("src, tgt and tgt_mask must be contiguous")
    n, m = src.shape[0], tgt.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=src.device)
    d2 = torch.empty(n, dtype=torch.float32, device=src.device)
    lib = _library()
    # the device guard costs more than the check that it is not needed
    guard = (contextlib.nullcontext()
             if src.device.index == torch.cuda.current_device()
             else torch.cuda.device(src.device))
    with guard:
        stream = _raw_stream(src.device.index)
        if simple:
            rc = lib.nn_launch_simple(src.data_ptr(), tgt.data_ptr(),
                                      tgt_mask.data_ptr(), n, m,
                                      idx.data_ptr(), d2.data_ptr(), stream)
        else:
            _tiles, slices, sub_len = plan(n, m, _sm_count(src.device.index))
            # the slices' partial (min d², argmin): [2][slices][n] 4-byte words
            scratch = torch.empty(2 * slices * n, dtype=torch.int32,
                                  device=src.device)
            rc = lib.nn_launch(src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(),
                               n, m, slices, sub_len,
                               idx.data_ptr(), d2.data_ptr(), scratch.data_ptr(),
                               scratch.data_ptr() + 4 * slices * n, stream)
    if rc != 0:
        raise RuntimeError(f"nn_kernel launch failed: CUDA error {rc}")
    return idx, d2


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor):
    """(idx [N] int32, d2 [N] float32) of the nearest valid target per
    source point. CUDA tensors run the kernel; CPU tensors the plain
    version."""
    global launches
    if src.device.type == "cpu":
        _check(src, tgt, tgt_mask)
        return nearest_neighbor_ref(src, tgt, tgt_mask)
    out = _launch(src, tgt, tgt_mask, simple=False)
    launches += 1
    return out


def _nearest_neighbor_simple(src: torch.Tensor, tgt: torch.Tensor,
                             tgt_mask: torch.Tensor):
    """The oracle kernel on CUDA tensors (same result as `nearest_neighbor`,
    bit for bit). Not counted in `launches`."""
    return _launch(src, tgt, tgt_mask, simple=True)
