"""Run artifact export: PCD maps, TUM trajectories, g2o pose graphs (port
of `xchu_slam_tpu.io.export`).

`save_run` writes `finalMap.pcd`, `trajectory.pcd`, `odom_tum.txt`
(optimized poses, optionally in the camera frame), `lidar_odom.txt` (raw
odometry), `pose_graph.g2o` (vertices and the full edge set),
`markers.json`, `odom_log.jsonl` and, where matplotlib is installed,
`map.png`. The writers and readers are numpy on the host; the pipeline
state comes off the device in a few bulk readbacks.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from xchu_slam_tpu_torch.io import kitti
from xchu_slam_tpu_torch.utils import se3


def write_pcd(path: str, xyz: np.ndarray, binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(xyz)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(xyz)}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(xyz.tobytes())
        else:
            for p in xyz:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n".encode())


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD reader (x y z float32, ascii or binary)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"DATA")
    header = data[:head_end].decode()
    fields = {}
    for line in header.splitlines():
        parts = line.split()
        if parts:
            fields[parts[0]] = parts[1:]
    n = int(fields["POINTS"][0])
    n_fields = len(fields["FIELDS"])
    mode_line = data[head_end:data.index(b"\n", head_end)].decode()
    body = data[data.index(b"\n", head_end) + 1:]
    if "binary" in mode_line:
        arr = np.frombuffer(body, np.float32, count=n * n_fields).reshape(n, n_fields)
    else:
        arr = np.loadtxt(body.decode().splitlines()).reshape(n, n_fields)
    return arr[:, :3].astype(np.float32)


def write_g2o(path: str, poses: np.ndarray, between_T: np.ndarray,
              loops: list[tuple[int, int, np.ndarray, float]],
              odom_info: tuple[float, float] = (1e6, 1e4)) -> None:
    """VERTEX_SE3:QUAT + EDGE_SE3:QUAT (with information matrices).

    poses: [N, 4, 4]; between_T: [N, 4, 4] (entry k = Z_{k-1,k});
    loops: list of (i, j, Z_ij [4,4], info_scalar)."""
    it, ir = odom_info

    def info_upper(diag6):
        M = np.diag(diag6)
        vals = []
        for r in range(6):
            for c in range(r, 6):
                vals.append(M[r, c])
        return " ".join(f"{v:.6g}" for v in vals)

    with open(path, "w") as f:
        for i, T in enumerate(poses):
            q = kitti.matrix_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(f"VERTEX_SE3:QUAT {i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n")
        odo_info_str = info_upper([it] * 3 + [ir] * 3)
        for k in range(1, len(poses)):
            Z = between_T[k]
            q = kitti.matrix_to_quat(Z[:3, :3])
            t = Z[:3, 3]
            f.write(f"EDGE_SE3:QUAT {k - 1} {k} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f} {odo_info_str}\n")
        for (i, j, Z, info) in loops:
            q = kitti.matrix_to_quat(Z[:3, :3])
            t = Z[:3, 3]
            li = info_upper([info] * 6)
            f.write(f"EDGE_SE3:QUAT {i} {j} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f} {li}\n")


def write_markers(path: str, poses: np.ndarray,
                  loops: list[tuple[int, int]]) -> None:
    """Pose-graph visualization markers as JSON: node spheres, odometry edges,
    loop edges, as a viewer-agnostic artifact."""
    nodes = [{"id": int(i), "xyz": [float(v) for v in T[:3, 3]]}
             for i, T in enumerate(poses)]
    odom_edges = [{"i": i - 1, "j": i} for i in range(1, len(poses))]
    loop_edges = [{"i": int(i), "j": int(j)} for (i, j) in loops]
    with open(path, "w") as f:
        json.dump({
            "nodes": nodes,                       # blue spheres
            "odometry_edges": odom_edges,         # green lines
            "loop_edges": loop_edges,             # red lines
        }, f)


def render_map_png(path: str, map_xyz: np.ndarray, traj_xyz: np.ndarray,
                   loops: list[tuple[int, int]], max_map_points: int = 200_000,
                   title: str = "") -> None:
    """Rendered run overview: top-down map + trajectory + loop edges to PNG
    (map cloud, blue pose nodes, green odometry path, red loop edges).
    Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    map_xyz = np.asarray(map_xyz)
    traj_xyz = np.asarray(traj_xyz)
    fig, ax = plt.subplots(figsize=(10, 10), dpi=110)
    if len(map_xyz):
        if len(map_xyz) > max_map_points:
            sel = np.linspace(0, len(map_xyz) - 1, max_map_points).astype(int)
            map_xyz = map_xyz[sel]
        z = map_xyz[:, 2]
        lo, hi = np.percentile(z, [2, 98]) if len(z) else (0.0, 1.0)
        ax.scatter(map_xyz[:, 0], map_xyz[:, 1], c=np.clip(z, lo, hi),
                   s=0.3, cmap="viridis", alpha=0.35, linewidths=0,
                   rasterized=True)
    if len(traj_xyz):
        ax.plot(traj_xyz[:, 0], traj_xyz[:, 1], "-", color="#2e7d32",
                lw=1.4, label="optimized trajectory")
        ax.scatter(traj_xyz[:, 0], traj_xyz[:, 1], s=4, color="#1565c0",
                   zorder=3, label="keyframes")
        ax.scatter(*traj_xyz[0, :2], marker="*", s=120, color="#1565c0",
                   zorder=4)
    for (i, j) in loops:
        if i < len(traj_xyz) and j < len(traj_xyz):
            ax.plot([traj_xyz[i, 0], traj_xyz[j, 0]],
                    [traj_xyz[i, 1], traj_xyz[j, 1]], "-", color="#c62828",
                    lw=1.0, alpha=0.9, zorder=5)
    if loops:
        ax.plot([], [], "-", color="#c62828", label=f"{len(loops)} loop edges")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_run(pipe, out_dir: str, to_camera_frame: bool = False,
             cam_T: np.ndarray | None = None) -> dict:
    """Export all run artifacts from a SlamPipeline. Returns file paths.

    `to_camera_frame` applies the KITTI velodyne→camera extrinsic so
    `odom_tum.txt` compares directly against KITTI GT files; `cam_T`
    overrides the extrinsic (e.g. a pure axis rotation for simulated runs
    with no lever arm)."""
    os.makedirs(out_dir, exist_ok=True)
    stamps, kf_odo, kf_opt = pipe.keyframe_trajectory()
    T_opt = se3.pose_to_matrix(torch.from_numpy(kf_opt)).numpy()
    T_odo = se3.pose_to_matrix(torch.from_numpy(kf_odo)).numpy()
    if cam_T is not None:
        inv = np.linalg.inv(cam_T)
        T_opt_out = cam_T @ T_opt @ inv
        T_odo_out = cam_T @ T_odo @ inv
    elif to_camera_frame:
        T_opt_out = kitti.velo_to_cam(T_opt)
        T_odo_out = kitti.velo_to_cam(T_odo)
    else:
        T_opt_out, T_odo_out = T_opt, T_odo

    paths = {}
    paths["odom_tum"] = os.path.join(out_dir, "odom_tum.txt")
    kitti.write_tum(paths["odom_tum"], stamps, T_opt_out)
    paths["lidar_odom"] = os.path.join(out_dir, "lidar_odom.txt")
    kitti.write_tum(paths["lidar_odom"], stamps, T_odo_out)

    paths["trajectory_pcd"] = os.path.join(out_dir, "trajectory.pcd")
    write_pcd(paths["trajectory_pcd"], T_opt[:, :3, 3])

    paths["final_map_pcd"] = os.path.join(out_dir, "finalMap.pcd")
    map_pts = pipe.assemble_map(voxel=0.5)
    write_pcd(paths["final_map_pcd"], map_pts)

    n, nl = pipe.kf_count, pipe.loop_count
    g = pipe.graph
    between = g.between_T[:n].cpu().numpy()
    loop_i, loop_j = g.loop_i[:nl].cpu().numpy(), g.loop_j[:nl].cpu().numpy()
    loop_T, loop_info = g.loop_T[:nl].cpu().numpy(), g.loop_info[:nl].cpu().numpy()
    loops = [(int(loop_i[q]), int(loop_j[q]), loop_T[q], float(loop_info[q]))
             for q in range(nl)]
    paths["g2o"] = os.path.join(out_dir, "pose_graph.g2o")
    write_g2o(paths["g2o"], T_opt, between, loops,
              odom_info=(pipe.gspec.odom_info_t, pipe.gspec.odom_info_r))

    paths["markers"] = os.path.join(out_dir, "markers.json")
    loop_pairs = [(i, j) for (i, j, _Z, _f) in loops]
    write_markers(paths["markers"], T_opt, loop_pairs)

    paths["map_png"] = os.path.join(out_dir, "map.png")
    try:
        render_map_png(paths["map_png"], map_pts, T_opt[:, :3, 3], loop_pairs,
                       title=f"{n} keyframes, {len(loop_pairs)} loops")
    except Exception as e:  # the one exception: rendering never fails an export
        del paths["map_png"]
        print(f"map.png render skipped: {e}")

    if pipe.odom_log:
        # per-scan diagnostics as JSONL
        paths["odom_log"] = os.path.join(out_dir, "odom_log.jsonl")
        with open(paths["odom_log"], "w") as f:
            for r in pipe.odom_log:
                row = {k: (v.tolist() if hasattr(v, "tolist") else v)
                       for k, v in r.items()}
                f.write(json.dumps(row) + "\n")
    return paths
