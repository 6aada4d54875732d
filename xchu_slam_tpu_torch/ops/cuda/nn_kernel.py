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
from pathlib import Path

import torch

from xchu_slam_tpu_torch.ops.cuda import _build

_SRC = _build.CSRC / "nn_kernel.cu"
NVCC_FLAGS = _build.BASE_FLAGS

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


def build() -> tuple[Path, float, str]:
    """Compile `csrc/nn_kernel.cu` unless the library for this source and
    these flags exists. Returns (library path, build seconds, nvcc output);
    the output (ptxas's figures) is kept beside the library, so a build
    that was already there returns it too."""
    return _build.build(_SRC, NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nn_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                              ptr, ptr, ptr, ptr, ptr, ptr]
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


def _launch(src, tgt, tgt_mask, simple: bool, live=None):
    """Check, allocate the outputs and launch one of the two kernels on
    PyTorch's current stream."""
    _check(src, tgt, tgt_mask)
    if live is not None and (live.device != src.device or live.dtype != torch.float32
                             or live.numel() != 1):
        raise ValueError("live must be one float32 on the kernel's device")
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
        stream = _build.raw_stream(src.device.index)
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
                               scratch.data_ptr() + 4 * slices * n,
                               None if live is None else live.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nn_kernel launch failed: CUDA error {rc}")
    return idx, d2


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                     live: torch.Tensor | None = None):
    """(idx [N] int32, d2 [N] float32) of the nearest valid target per
    source point. CUDA tensors run the kernel; CPU tensors the plain
    version. `live` (one float32 on the card) makes the kernel return at
    once, its outputs unwritten, where it is not > 0.5: what a loop
    captured in a CUDA graph (`ops/icp.py`) does on its finished trips. The
    plain version ignores it."""
    global launches
    if src.device.type == "cpu":
        _check(src, tgt, tgt_mask)
        return nearest_neighbor_ref(src, tgt, tgt_mask)
    out = _launch(src, tgt, tgt_mask, simple=False, live=live)
    launches += 1
    return out


def _nearest_neighbor_simple(src: torch.Tensor, tgt: torch.Tensor,
                             tgt_mask: torch.Tensor):
    """The oracle kernel on CUDA tensors (same result as `nearest_neighbor`,
    bit for bit). Not counted in `launches`."""
    return _launch(src, tgt, tgt_mask, simple=True)
