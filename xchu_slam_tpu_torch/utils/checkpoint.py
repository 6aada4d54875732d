"""Mid-run checkpoint / resume of the host engine (port of
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
"""

from __future__ import annotations

import json

import numpy as np
import torch

# dtypes of the arrays whose type in the port differs from the file's
_FILE_DTYPES = {"db.count": np.int32, "graph.loop_i": np.int32,
                "graph.loop_j": np.int32}


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
    """Checkpoint a `SlamPipeline` to `path` (.npz)."""
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


def _migrate_legacy(data: dict) -> None:
    """In-place migration of the older checkpoint layout that kept a voxel
    grid's finalized tables apart (`mean`, `icov`, `valid`) into the one
    `fin[V,10]` table. Exactly reconstructible, so old sessions stay
    loadable; unknown missing keys still fail, with an error that names the
    checkpoint."""
    for key in [k for k in data if k.endswith(".mean")]:
        p = key[: -len(".mean")]
        if f"{p}.fin" in data or f"{p}.icov" not in data \
                or f"{p}.valid" not in data:
            continue
        data[f"{p}.fin"] = np.concatenate(
            [np.asarray(data[f"{p}.mean"], np.float32),
             np.asarray(data[f"{p}.icov"], np.float32),
             np.asarray(data[f"{p}.valid"], np.float32)[:, None]], axis=-1)


def load_checkpoint(path: str, device: torch.device | str = "cuda"):
    """Restore a `SlamPipeline` on `device` from a checkpoint file that this
    package or the reference's host engine wrote."""
    from xchu_slam_tpu_torch.config import SlamConfig
    from xchu_slam_tpu_torch.models import odometry
    from xchu_slam_tpu_torch.models.pipeline import KfDb, LoopRecord, SlamPipeline
    from xchu_slam_tpu_torch.models.pose_graph import GraphData
    from xchu_slam_tpu_torch.ops import imu as imu_ops
    from xchu_slam_tpu_torch.types import VoxelGrid

    with np.load(path) as npz:
        data = dict(npz.items())
    _migrate_legacy(data)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta.get("engine") == "device":
        raise ValueError(
            f"checkpoint {path!r} was saved by the device engine "
            "(DeviceSlamPipeline), which is not ported: only host-engine "
            "checkpoints load")
    cfg = SlamConfig.from_json(meta["config"])
    pipe = SlamPipeline(cfg, kf_points=meta["kf_points"], device=device)

    nested = {("OdomState", "grid_a"): VoxelGrid,
              ("OdomState", "grid_b"): VoxelGrid}
    # the types the port holds where they are not the file's
    casts = {"db.count": int, "graph.loop_i": torch.int64,
             "graph.loop_j": torch.int64}

    def unflatten(prefix, cls):
        vals = []
        for name in cls._fields:
            key = f"{prefix}.{name}"
            if key in data:
                cast = casts.get(key)
                if cast is int:
                    vals.append(int(data[key]))
                else:
                    vals.append(torch.from_numpy(np.array(data[key]))
                                .to(pipe.device, cast))
            elif (cls.__name__, name) in nested:
                vals.append(unflatten(key, nested[(cls.__name__, name)]))
            else:
                raise ValueError(
                    f"checkpoint {path!r} is missing {key!r}: saved by an "
                    "incompatible version of this package")
        return cls(*vals)

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
    return pipe
