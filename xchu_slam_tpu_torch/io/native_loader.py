"""ctypes bindings for the native (C++) scan loader and prefetcher (port of
`xchu_slam_tpu.io.native_loader`).

`native/loader.cpp` reads KITTI velodyne `.bin` scans, drops records with a
non-finite coordinate, optionally crops the horizontal range, and writes
them into fixed-capacity buffers; its prefetcher is a reader thread that
loads scan k+1 while scan k is consumed. The library is built at first use
from that source with the host compiler into `build/native/` (gitignored),
keyed by the source's hash and the flags as the kernels are
(`ops/cuda/_build.py`); nothing is built into `native/`, and the library
committed there, built for another machine, is never loaded.

Where the library cannot be built or loaded, `read_velodyne` falls back to
a numpy reader with the same rules, and says so: `reader()` names the
reader that runs ("native" or "numpy"), `run-kitti` puts it in its summary
and the reason goes to stderr once. The two readers agree bit for bit: a
record is dropped when x, y or z is non-finite (its intensity is passed
as it is), the crop keeps r² = x² + y² in (min², max²) computed in float32,
and the scan is cut at `capacity` valid records.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared", "-pthread")

_lib = None
_error: str | None = None   # why the native library is unavailable


def build():
    """Compile `native/loader.cpp` with the host compiler into `build/native/`
    unless the library of this source and these flags is there: (library
    path, build seconds, compiler output)."""
    from xchu_slam_tpu_torch.ops.cuda import _build

    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError("no host C++ compiler (g++) found")
    return _build.build(SOURCE, FLAGS, compiler, BUILD_DIR)


def _load():
    lib = ctypes.CDLL(str(build()[0]))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.xst_read_velodyne.restype = ctypes.c_int64
    lib.xst_read_velodyne.argtypes = [ctypes.c_char_p, f32p, f32p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float]
    lib.xst_prefetcher_create.restype = ctypes.c_void_p
    lib.xst_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    lib.xst_prefetcher_get.restype = ctypes.c_int64
    lib.xst_prefetcher_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, f32p, f32p]
    lib.xst_prefetcher_destroy.restype = None
    lib.xst_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The native library, built at first use; None if it cannot be built
    or loaded (the reason is printed once and kept in `unavailable_reason`)."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _load()
        except (OSError, RuntimeError) as exc:
            _error = str(exc).strip().splitlines()[0] if str(exc).strip() else repr(exc)
            print(f"native scan loader unavailable ({_error}); reading with numpy",
                  file=sys.stderr)
    return _lib


def unavailable_reason() -> str | None:
    return _error


def available() -> bool:
    return get_lib() is not None


def reader() -> str:
    """The reader `read_velodyne` uses: "native" or "numpy"."""
    return "native" if available() else "numpy"


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_velodyne_numpy(path: str, capacity: int, min_range: float = 0.0,
                        max_range: float = 0.0):
    """The numpy reader: (xyz [capacity,3], intensity [capacity], n_valid),
    by the native reader's rules."""
    raw = np.fromfile(path, dtype=np.float32)
    pts = raw[:len(raw) // 4 * 4].reshape(-1, 4)
    pts = pts[np.isfinite(pts[:, :3]).all(axis=1)]
    if min_range > 0.0 or max_range > 0.0:
        lo = np.float32(min_range) * np.float32(min_range)
        hi = np.float32(max_range) * np.float32(max_range) if max_range > 0.0 \
            else np.float32(3.4e38)
        x, y = pts[:, 0], pts[:, 1]
        r2 = x * x + y * y
        pts = pts[(r2 > lo) & (r2 < hi)]
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros((capacity,), np.float32)
    n = min(len(pts), capacity)
    xyz[:n] = pts[:n, :3]
    inten[:n] = pts[:n, 3]
    return xyz, inten, n


def read_velodyne(path: str, capacity: int, min_range: float = 0.0,
                  max_range: float = 0.0):
    """Read one scan → (xyz [capacity,3], intensity [capacity], n_valid),
    zero-padded past n_valid: natively, or with numpy where the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return read_velodyne_numpy(path, capacity, min_range, max_range)
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros((capacity,), np.float32)
    n = lib.xst_read_velodyne(str(path).encode(), _f32p(xyz), _f32p(inten), capacity,
                              min_range, max_range)
    if n < 0:
        raise FileNotFoundError(path)
    return xyz, inten, int(n)


class ScanPrefetcher:
    """Double-buffered background scan loader over a file list (the native
    library's reader thread): `get(k)` blocks until scan k is loaded. Take
    the scans in order, each once: the reader thread fills two slots ahead
    and waits for the older one to be taken."""

    def __init__(self, files: list[str], capacity: int, min_range: float = 0.0,
                 max_range: float = 0.0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self.lib = lib
        self.capacity = capacity
        # the C side keeps copies of the paths; the array is kept for the call
        self._paths = (ctypes.c_char_p * len(files))(*[str(f).encode() for f in files])
        self.handle = lib.xst_prefetcher_create(self._paths, len(files), capacity,
                                                min_range, max_range)

    def get(self, idx: int):
        if not self.handle:
            raise RuntimeError("the prefetcher is closed")
        xyz = np.zeros((self.capacity, 3), np.float32)
        inten = np.zeros((self.capacity,), np.float32)
        n = self.lib.xst_prefetcher_get(self.handle, idx, _f32p(xyz), _f32p(inten))
        if n < 0:
            raise IndexError(idx)
        return xyz, inten, int(n)

    def close(self) -> None:
        if self.handle:
            self.lib.xst_prefetcher_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()
