"""Mid-run checkpoint / resume of either engine (port of
`xchu_slam_tpu.utils.checkpoint`), in the reference's `.npz` layout: each
package loads the other's files.

The full SLAM state goes into one compressed npz: the keyframe database
(`db.*`), the factor graph (`graph.*`), the odometry state with both voxel
grids (`odom.*`, each grid's `fin` as the base [V,10] table, which is what
the reference stores and what the port holds), and `__meta__`, the host
counters and the config as JSON bytes. Arrays are written in the
reference's dtypes (`db.count` an int32 scalar, `graph.loop_i/j` int32).

Two `__meta__` keys are the port's own: `imu_velocity` and `last_stamp`, the
IMU guess state, which the reference's host-engine files lack (its loader
reads the keys it knows by name and ignores others). A file without them
loads as the reference resumes: zero velocity, and no velocity reset on the
first scan after the resume.

A device-engine file (`DeviceSlamPipeline`, saved at a chunk boundary) holds
the engine's `DevState` under `state.*` in the reference's field order, each
grid's `fin` in its base form, the counters as int32 (`state.loop_count`,
`state.scan_count`, `state.db.count`, `state.graph.loop_i/j`), and
`__meta__` with `engine: "device"`, `kf_points`, `log_capacity` and the
config. The port's own device keyframe counter is not written: it is the
store's count.

Under a mesh (`DeviceSlamPipeline(mesh=)`) every rank holds the same state:
rank 0 alone writes the file, in the same layout, and `load_checkpoint(...,
mesh=)` restores it on every rank of a group as a mesh pipeline.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# dtypes of the arrays whose type in the port differs from the file's
_FILE_DTYPES = {key: np.int32 for key in (
    "db.count", "graph.loop_i", "graph.loop_j", "state.db.count", "state.graph.loop_i",
    "state.graph.loop_j", "state.loop_count", "state.scan_count")}
# the types the port holds where they are not the file's
_CASTS = {"db.count": int, "graph.loop_i": torch.int64, "graph.loop_j": torch.int64,
          "state.db.count": int, "state.graph.loop_i": torch.int64,
          "state.graph.loop_j": torch.int64, "state.loop_count": torch.int64,
          "state.scan_count": torch.int64}


def _flatten(prefix: str, tree) -> dict:
    out = {}
    for name, val in zip(tree._fields, tree):
        key = f"{prefix}.{name}"
        if hasattr(val, "_fields"):
            out.update(_flatten(key, val))
        elif isinstance(val, torch.Tensor):
            out[key] = val.detach().cpu().numpy()
        else:
            out[key] = np.asarray(val)
        if key in _FILE_DTYPES:
            out[key] = out[key].astype(_FILE_DTYPES[key])
    return out


def save_checkpoint(pipe, path: str) -> None:
    """Checkpoint a `SlamPipeline` or, at a chunk boundary, a
    `DeviceSlamPipeline` to `path` (.npz). A mesh pipeline's state is
    replicated: its rank 0 writes the file and the other ranks write
    nothing."""
    if hasattr(pipe, "state"):
        _save_device_checkpoint(pipe, path)
        return
    arrays = {}
    arrays.update(_flatten("db", pipe.db))
    arrays.update(_flatten("graph", pipe.graph))
    if pipe.odom_state is not None:
        arrays.update(_flatten("odom", pipe.odom_state))
    meta = {
        "engine": "host",
        "loop_count": pipe.loop_count,
        "scan_count": pipe.scan_count,
        "kf_gate_accum": pipe.kf_gate_accum,
        "travel": pipe.travel,
        "kf_points": pipe.kf_points,
        "loops": [(r.i, r.j, r.fitness, r.method) for r in pipe.loops],
        "last_odom_pose": None if pipe._last_odom_pose is None
        else np.asarray(pipe._last_odom_pose).tolist(),
        "last_kf_odom": None if pipe._last_kf_odom is None
        else np.asarray(pipe._last_kf_odom).tolist(),
        "config": pipe.cfg.to_json(),
        "imu_velocity": pipe._imu_state.velocity.tolist(),
        "last_stamp": pipe._last_stamp,
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _save_device_checkpoint(pipe, path: str) -> None:
    if pipe.state is None:
        raise ValueError("device pipeline has no state yet (no scans fed)")
    if pipe.mesh is not None and pipe.mesh.rank != 0:
        return
    arrays = _flatten("state", pipe.state)
    del arrays["state.kf_count"]      # the store's count; the reference has none
    meta = {
        "engine": "device",
        "kf_points": pipe.kf_points,
        "log_capacity": pipe.spec.log_capacity,
        "config": pipe.cfg.to_json(),
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _migrate_legacy(data: dict) -> None:
    """In-place migration of older checkpoint layouts: a voxel grid's
    finalized tables kept apart (`mean`, `icov`, `valid`) become the one
    `fin[V,10]` table, and a device-engine file without `state.last_stamp`
    gets the newest stamp of its log ring (not 0, which would make the first
    resumed scan's velocity-reset interval the absolute stamp). Both are
    exactly reconstructible, so old sessions stay loadable; unknown missing
    keys still fail, with an error that names the checkpoint."""
    for key in [k for k in data if k.endswith(".mean")]:
        p = key[: -len(".mean")]
        if f"{p}.fin" in data or f"{p}.icov" not in data \
                or f"{p}.valid" not in data:
            continue
        data[f"{p}.fin"] = np.concatenate(
            [np.asarray(data[f"{p}.mean"], np.float32),
             np.asarray(data[f"{p}.icov"], np.float32),
             np.asarray(data[f"{p}.valid"], np.float32)[:, None]], axis=-1)
    if "state.scan_count" in data and "state.last_stamp" not in data:
        last = np.float32(0.0)
        if "state.log" in data:
            log = np.asarray(data["state.log"])
            n = int(np.asarray(data["state.scan_count"]))
            if log.ndim == 2 and log.shape[1] >= 11 and n > 0:
                last = np.float32(log[:min(n, log.shape[0]), 10].max())
        data["state.last_stamp"] = last


def _unflatten(data: dict, path: str, prefix: str, cls, device, extra=None):
    """The NamedTuple `cls` from the file's `prefix.*` arrays, as tensors on
    `device` in the port's types; `extra` gives fields the file does not
    hold."""
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.models.device_pipeline import DevState
    from xchu_slam_tpu_torch.models.pipeline import KfDb
    from xchu_slam_tpu_torch.models.pose_graph import GraphData
    from xchu_slam_tpu_torch.types import VoxelGrid

    nested = {"odom": odometry.OdomState, "db": KfDb, "graph": GraphData,
              "grid_a": VoxelGrid, "grid_b": VoxelGrid}
    nested_in = (DevState, odometry.OdomState)
    vals = []
    for name in cls._fields:
        key = f"{prefix}.{name}"
        if extra and name in extra:
            vals.append(extra[name])
        elif key in data:
            cast = _CASTS.get(key)
            if cast is int:
                vals.append(int(data[key]))
            else:
                vals.append(torch.from_numpy(np.array(data[key])).to(device, cast))
        elif cls in nested_in and name in nested:
            vals.append(_unflatten(data, path, key, nested[name], device))
        else:
            raise ValueError(f"checkpoint {path!r} is missing {key!r}: saved by an "
                             "incompatible version of this package")
    return cls(*vals)


def _load_device(data: dict, meta: dict, cfg, path: str, device, mesh=None):
    from xchu_slam_tpu_torch.models.device_pipeline import DeviceSlamPipeline, DevState

    for key in ("state.db.count", "state.scan_count"):
        if key not in data:
            raise ValueError(f"checkpoint {path!r} is missing {key!r}: saved by an "
                             "incompatible version of this package")
    pipe = DeviceSlamPipeline(cfg, kf_points=meta["kf_points"],
                              log_capacity=meta["log_capacity"], device=device, mesh=mesh)
    count = int(data["state.db.count"])
    kf_count = torch.full((), count, dtype=torch.int64, device=pipe.device)
    state = _unflatten(data, path, "state", DevState, pipe.device,
                       extra={"kf_count": kf_count})
    pipe.restore(state, int(data["state.scan_count"]))
    return pipe


def load_checkpoint(path: str, device: torch.device | str | None = None, mesh=None):
    """Restore a pipeline on `device` (default "cuda", or the mesh's
    device) from a checkpoint file that this package or the reference wrote:
    a `SlamPipeline` from a host-engine file, a `DeviceSlamPipeline` from a
    device-engine one (ready for its next chunk). With `mesh` (this rank's
    `parallel.distributed.Mesh`; every rank of the group calls it) a
    device-engine file becomes a mesh pipeline, its state on this rank's
    device; a host-engine file is refused."""
    from xchu_slam_tpu_torch.config import SlamConfig
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.models.pipeline import KfDb, LoopRecord, SlamPipeline
    from xchu_slam_tpu_torch.models.pose_graph import GraphData
    from xchu_slam_tpu_torch.ops import imu as imu_ops

    with np.load(path) as npz:
        data = dict(npz.items())
    _migrate_legacy(data)
    meta = json.loads(bytes(data["__meta__"]).decode())
    cfg = SlamConfig.from_json(meta["config"])
    if meta.get("engine") == "device":
        return _load_device(data, meta, cfg, path, device, mesh)
    if mesh is not None:
        raise ValueError(f"checkpoint {path!r} is a host-engine file: only the device "
                         "engine runs on a mesh")
    pipe = SlamPipeline(cfg, kf_points=meta["kf_points"],
                        device="cuda" if device is None else device)

    def unflatten(prefix, cls):
        return _unflatten(data, path, prefix, cls, pipe.device)

    pipe.db = unflatten("db", KfDb)
    pipe.graph = unflatten("graph", GraphData)
    if "odom.pose" in data:
        pipe.odom_state = unflatten("odom", odometry.OdomState)
    pipe.loop_count = int(meta["loop_count"])
    pipe.scan_count = int(meta["scan_count"])
    pipe.kf_count = pipe.db.count
    pipe.kf_gate_accum = float(meta["kf_gate_accum"])
    pipe.travel = float(meta["travel"])
    pipe.loops = [LoopRecord(i=i, j=j, fitness=f, method=m)
                  for (i, j, f, m) in meta["loops"]]
    if meta["last_odom_pose"] is not None:
        pipe._last_odom_pose = np.asarray(meta["last_odom_pose"], np.float32)
    if meta["last_kf_odom"] is not None:
        pipe._last_kf_odom = np.asarray(meta["last_kf_odom"], np.float32)
    if meta.get("imu_velocity") is not None:
        pipe._imu_state = imu_ops.ImuState(
            velocity=torch.tensor(meta["imu_velocity"], dtype=torch.float32))
    if meta.get("last_stamp") is not None:
        pipe._last_stamp = float(meta["last_stamp"])
    pipe._publish()   # the loop worker's snapshot is the restored database
    return pipe
