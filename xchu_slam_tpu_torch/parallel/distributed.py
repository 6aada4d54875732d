"""Process groups and meshes of the port (port of
`xchu_slam_tpu.parallel.distributed`) on `torch.distributed`.

The reference forms one SPMD program over a JAX mesh and names its axis in
every sharded body. The port runs one process a rank and passes a `Mesh`
instead: the process group, this rank, the group's size and backend, and
the device this rank computes on. `None` where a mesh may be passed means
one device. Inputs stay replicated: every rank holds the whole tensors and
computes on its own rows [r·N/D, (r+1)·N/D) (`Mesh.shard`, the reference's
`ops/ndt.py::_local_shard`), and the partial results meet in the packed
collectives of `utils/collectives.py`.

Three transports:
- gloo on the CPU (`initialize_cpu`), as the tests run it;
- NCCL, one card a rank (more ranks than visible cards are refused by
  name: NCCL does not put two ranks on one card);
- gloo carrying CUDA tensors, for several ranks that share one card: each
  collective is staged through pinned host memory (`utils/collectives.py`).

`launch` starts a group of ranks, each a fresh interpreter (never a fork of
the caller, which may hold threads or a CUDA context), joined through a
`file://` store in a fresh temporary directory, with every wait bounded:

    python -m xchu_slam_tpu_torch.parallel.distributed <run dir> <rank>

is how each rank starts; the caller never types it.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# seconds a launched rank waits to form its group, and for each collective
GROUP_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group, this rank, the
    group's size and backend, and the device this rank computes on."""

    group: object
    rank: int
    size: int
    backend: str
    device: torch.device

    def shard(self, n: int, axis: str) -> slice:
        """This rank's rows of a leading axis of length `n` (named `axis` in
        the error): [rank·n/size, (rank+1)·n/size)."""
        if n % self.size:
            raise ValueError(f"{axis}: leading axis {n} is not divisible by the mesh "
                             f"size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None, timeout_s: float = 60.0) -> Mesh | None:
    """Join (or form) the process group and return this rank's mesh over all
    of it.

    Arguments default from torchrun's variables (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT` through `env://`). With none
    of them, one process, it is a no-op that returns None. The backend
    defaults to NCCL on a CUDA device and gloo otherwise; the device to
    `cuda:<LOCAL_RANK>` under NCCL and the CPU under gloo. NCCL with more
    ranks than visible cards is refused by name. `timeout_s` bounds forming
    the group and every collective after it."""
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    if world_size is None and rank is None:
        return None
    if world_size is None or rank is None:
        raise ValueError("give both the world size and the rank (or WORLD_SIZE and RANK)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"NCCL needs one card a rank: {world_size} ranks, {cards} "
                             "visible cards; ranks that share a card run over gloo")
        device = torch.device("cuda", local_rank) if device is None else device
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu") if device is None else device
        if device.type == "cuda":
            torch.cuda.set_device(device)
    else:
        raise ValueError(f"unknown backend {backend!r}: the port runs gloo and nccl")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("no init_method and no MASTER_ADDR / MASTER_PORT")
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return global_mesh(device)


def initialize_cpu(init_method: str, world_size: int, rank: int,
                   timeout_s: float = 60.0) -> Mesh:
    """A gloo group on the CPU: the testable stand-in for a group of cards,
    whose every collective crosses the process boundary where it would cross
    NVLink."""
    return initialize("gloo", init_method, world_size, rank, "cpu", timeout_s)


def global_mesh(device=None) -> Mesh:
    """The 1-D mesh over every rank of the default group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize first")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=dist.get_world_size(),
                backend=backend, device=torch.device(device))


def host_local_mesh(device=None) -> Mesh:
    """The mesh over this host's ranks only (`LOCAL_WORLD_SIZE` of them a
    host, all of them where it is not set). Every rank must call it: the
    subgroups are formed together."""
    mesh = global_mesh(device)
    local = _env_int("LOCAL_WORLD_SIZE") or mesh.size
    if local == mesh.size:
        return mesh
    group, _all = dist.new_subgroups(group_size=local)
    return Mesh(group=group, rank=mesh.rank % local, size=local, backend=mesh.backend,
                device=mesh.device)


def topology() -> dict:
    """This process's place: its rank, the ranks in all, the cards it sees
    and the ranks of the group (one process, one device without a group)."""
    on = dist.is_initialized()
    return {"process_index": dist.get_rank() if on else 0,
            "process_count": dist.get_world_size() if on else 1,
            "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
            "global_devices": dist.get_world_size() if on else 1}


# ------------------------------------------------------------------ launch -- #


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _stamp(run_dir: str, rank: int) -> float:
    """When the rank failed, by its own clock stamp (inf if it left none)."""
    try:
        with open(os.path.join(run_dir, f"failed{rank}")) as f:
            return float(f.read())
    except (OSError, ValueError):
        return float("inf")


def launch(world: int, target: str, args: tuple = (), backend: str = "gloo",
           device: str = "cpu", timeout_s: float = 120.0, path: tuple = (),
           setup: str | None = None) -> list:
    """Run `target` ("module:function", called as function(mesh, *args)) on a
    group of `world` ranks and return each rank's result, rank 0's first.
    With `setup` ("module:function"), each rank first calls function(*args)
    before it forms its group (before it touches CUDA: where it forks
    worker processes, say) and then calls the target as function(mesh,
    *args, made) with what it made; `made` is closed (its `close()`, where it
    is not None) however the rank ends. A rank killed at `timeout_s` runs no
    `close()`: what it made must end with it (forked workers see their pipes
    close).

    Each rank is a fresh interpreter (`sys.executable -m` this module) with
    one torch thread, joined through a `file://` store in a fresh temporary
    directory; `path` entries go in front of its module search path.
    `device` is "cpu", "cuda" (rank r on card r under NCCL, every rank on
    card 0 under gloo) or a device name. The arguments and results cross as
    `torch.save` files. When a rank exits non-zero, every other rank is
    killed and a RuntimeError names the rank that failed first, its exit
    code and the end of its stderr; so it is when the group is not done
    within `timeout_s`."""
    if world < 1:
        raise ValueError(f"a group needs at least one rank, got {world}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL needs one card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} visible cards; ranks that share a "
                         "card run over gloo")
    run_dir = tempfile.mkdtemp(prefix="xst_mesh_")
    procs = []
    try:
        torch.save(tuple(args), os.path.join(run_dir, "args.pt"))
        with open(os.path.join(run_dir, "spec.json"), "w") as f:
            json.dump({"world": world, "target": target, "backend": backend,
                       "device": device, "setup": setup,
                       "init_method": "file://" + os.path.join(run_dir, "store")}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [*map(os.path.abspath, path), _PACKAGE_PARENT]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for r in range(world):
            out = open(os.path.join(run_dir, f"out{r}.txt"), "wb")
            err = open(os.path.join(run_dir, f"err{r}.txt"), "wb")
            with out, err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "xchu_slam_tpu_torch.parallel.distributed",
                     run_dir, str(r)], stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                    env=env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # the others fail soon after the first (their peer is gone):
                # name the rank that failed first, by the time it stamped
                grace = time.monotonic() + 3.0
                while any(c is None for c in codes) and time.monotonic() < grace:
                    time.sleep(0.02)
                    codes = [p.poll() for p in procs]
                r = min((r for r, c in enumerate(codes) if c not in (None, 0)),
                        key=lambda r: _stamp(run_dir, r))
                raise RuntimeError(
                    f"rank {r} of {world} ({target}, {backend}) exited with code "
                    f"{codes[r]} (exit codes {codes}); its stderr ends:\n"
                    f"{_tail(os.path.join(run_dir, f'err{r}.txt'))}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                # the ranks that have not returned from the target (the
                # others wait for them in a collective)
                late = [r for r, c in enumerate(codes) if c is None and not
                        os.path.exists(os.path.join(run_dir, f"result{r}.pt"))]
                late = late or [r for r, c in enumerate(codes) if c is None]
                raise RuntimeError(
                    f"ranks {late} of {world} ({target}, {backend}) had not returned "
                    f"after {timeout_s} s; rank {late[0]}'s stderr ends:\n"
                    f"{_tail(os.path.join(run_dir, f'err{late[0]}.txt'))}")
            time.sleep(0.02)
        return [torch.load(os.path.join(run_dir, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        shutil.rmtree(run_dir, ignore_errors=True)


def _function(name: str):
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def _rank_main(run_dir: str, rank: int) -> None:
    """One rank of `launch`: make what `setup` makes, form the group, run
    the target, save its result; close what setup made however it ends."""
    with open(os.path.join(run_dir, "spec.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    world, backend = spec["world"], spec["backend"]
    device = spec["device"]
    if device == "cuda":
        device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    made = None
    try:
        args = torch.load(os.path.join(run_dir, "args.pt"), weights_only=False)
        setup = spec.get("setup")
        if setup:
            # before the group: initialize() touches CUDA
            made = _function(setup)(*args)
        mesh = initialize(backend, spec["init_method"], world, rank, device,
                          GROUP_TIMEOUT_S)
        try:
            result = _function(spec["target"])(mesh, *args, *((made,) if setup else ()))
            tmp = os.path.join(run_dir, f"result{rank}.tmp")
            torch.save(result, tmp)
            os.replace(tmp, os.path.join(run_dir, f"result{rank}.pt"))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(run_dir, f"failed{rank}"), "w") as f:
            f.write(repr(time.time()))
        raise
    finally:
        if made is not None:
            made.close()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
