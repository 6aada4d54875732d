"""nvcc builds of the package's CUDA sources into shared libraries with a
plain C interface, loaded with ctypes.

A source is compiled at first use into `build/kernels/` at the repository
root, keyed by the hash of the source and the flags, and the compiler's
output (ptxas's registers, shared memory and spills) is kept beside the
library. `io/native_loader.py` builds the host scan loader the same way,
with the host compiler, into `build/native/`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(src: Path, flags: tuple[str, ...] = BASE_FLAGS, compiler: str | None = None,
          out_dir: Path = BUILD_DIR) -> tuple[Path, float, str]:
    """Compile `src` with `compiler` (default nvcc) into `out_dir` unless the
    library for this source and these flags exists. Returns (library path,
    build seconds, compiler output); a build that was already there returns
    the kept output."""
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = out_dir / f"{src.stem}-{key}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, 0.0, log.read_text()
    compiler = compiler or nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def raw_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on that device (the
    capturing stream while a CUDA graph is being captured). PyTorch's
    internal getter costs a third of the public call; where a PyTorch version
    lacks it, the public call gives the same stream."""
    import torch

    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is not None:
        return getter(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream
