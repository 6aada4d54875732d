"""Typed configuration tree, a copy of `xchu_slam_tpu.config`.

The port carries its own copy so that it never imports the JAX package; a
test holds `dataclasses.asdict(default_config())` equal to the reference's.

Mirrors the reference's ROS-param + hard-coded constant inventory
(see reference `src/odom_node.cpp:43-90`, `src/pgo_node.cpp:49-64`,
`src/filter_node.cpp:31`, `launch/xchu_mapping.launch:11-27`,
`include/scancontext/Scancontext.h:83-104`, `include/isc/ISCGeneration.h:37-43`)
as one frozen dataclass tree with file/CLI override hooks.

All shape-determining fields are static Python ints: they size the port's
fixed-capacity tensors exactly as they size the reference's arrays.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FilterConfig:
    """Front-end preprocessing (reference `filter_node.cpp:236-273`)."""

    min_range: float = 1.0          # annulus crop (filter_node.cpp:242-247)
    max_range: float = 60.0
    voxel_size: float = 0.5         # downsample leaf (filter_node.cpp:250)
    outlier_method: str = "radius"  # "radius" | "statistical" |
    #                                 "statistical_approx" (hardware
    #                                 approx_min_k kNN, recall ≥ ~0.95 —
    #                                 see ops.filter) |
    #                                 "statistical_bucketed" | "none"
    radius_outlier_radius: float = 0.8   # (filter_node.cpp:264-273)
    radius_outlier_min_neighbors: int = 5
    stat_outlier_k: int = 30             # (filter_node.cpp:255-262)
    stat_outlier_stddev: float = 1.0
    stat_chunk: int = 0                  # row-chunk for the statistical
    # filter's pairwise pass: 0 = auto (one fused pass — fastest, measured
    # 2.3× over chunking — while max_points ≤ 16384; row-chunked above that
    # so the [n,n] f32 distance matrix stays bounded instead of growing
    # quadratically with the post-downsample capacity)
    # spatially-bucketed statistical filter (ops/filter.py): bucket size is
    # stat_bucket_mult·voxel_size (occupancy then bounded by the downsample),
    # unproven rows re-solved exactly up to stat_fallback_rows per scan
    stat_bucket_mult: int = 4
    stat_fallback_rows: int = 1024
    detect_ground: bool = False     # emit plane coeffs per scan (FloorCoeffs
    # analogue — the reference publishes them but nothing consumes them)
    # static shapes
    max_raw_points: int = 131072    # HDL-64 scan upper bound
    max_points: int = 16384         # post-filter cloud capacity


@dataclass(frozen=True)
class GroundConfig:
    """Ground segmentation (reference `filter_node.cpp:72-216`)."""

    sensor_height: float = 1.73     # KITTI velodyne height
    height_clip: float = 2.5        # PlaneClip band (filter_node.cpp:113-115)
    normal_knn: int = 10            # NormalFiltering k (filter_node.cpp:84)
    normal_angle_deg: float = 20.0  # max tilt of per-point normal vs +Z
    ransac_iters: int = 128
    ransac_thresh: float = 0.1      # plane distance (filter_node.cpp:148-155)
    plane_angle_deg: float = 10.0   # verticality check (filter_node.cpp:162-172)


@dataclass(frozen=True)
class NdtConfig:
    """NDT scan-to-localmap registration (reference `odom_node.cpp:56-90`,
    `pclomp/ndt_omp_impl.hpp:75-164`)."""

    resolution: float = 2.0
    step_size: float = 0.1          # More-Thuente max step
    trans_eps: float = 0.01         # convergence epsilon on |Δp|
    max_iterations: int = 30
    outlier_ratio: float = 0.55     # Gaussian d1/d2 mixture (ndt_omp_impl.hpp:80-87)
    min_points_per_voxel: int = 6   # (voxel_grid_covariance_omp.h:204)
    eig_inflation: float = 0.01     # λ_min floor = 0.01·λ_max (_impl.hpp:343-357)
    line_search_max_trials: int = 10
    ls_mode: str = "backtrack"      # line-search algorithm: "backtrack"
    # (Armijo+curvature backtrack, default), "mt_exact" (faithful live
    # More-Thuente, transliterated from ndt_omp_impl.hpp:646-916 and
    # oracle-tested trial-for-trial), "ref_clamped" (the reference's
    # EXECUTED behavior: its interval_converged init at :806 makes the MT
    # loop dead code, so every iteration takes clamp(|Δp|, eps/2,
    # step_size) with zero trials). See ops.ndt.NdtSpec.ls_mode.
    neighbor_mode: str = "direct7"  # voxel neighborhood per transformed point
    # (reference pclomp::NeighborSearchMethod, ndt_omp.h:52-57, dispatch
    # ndt_omp_impl.hpp:231-245): "direct1" = centre voxel only, "direct7" =
    # centre + 6 faces (reference default), "direct26" = full 3x3x3 cube
    # (PCL's getAllNeighborCellIndices = 26 neighbors + centre), "kdtree" =
    # radiusSearch(resolution) over leaf centroids — implemented exactly as
    # the 27-cube masked to centroid distance < resolution (any centroid
    # within `resolution` of the query provably lies in the 27-cube).
    regather_dist: float = 0.0      # reuse the DIRECT7 neighborhood across
    # Newton iterations until the pose moves this far (m; rotation weighted —
    # see ops.ndt.NdtSpec). 0.0 = fresh gather every iteration (reference
    # behavior, ndt_omp_impl.hpp:231-245); convergence on a stale
    # neighborhood is never accepted (a fresh-gather iteration is forced).
    source_points: int = 8192       # fixed NDT source cloud size
    # dense rolling voxel grid extent (voxels); ±(n/2)·resolution around anchor
    grid_x: int = 80
    grid_y: int = 80
    grid_z: int = 24
    recentre_margin: float = 20.0   # roll grid when pose this close to edge


@dataclass(frozen=True)
class OdomConfig:
    """Odometry / localmap maintenance (reference `odom_node.cpp:329-356`)."""

    min_add_scan_shift: float = 0.5   # append scan to localmap every 0.5 m
    max_localmap_size: float = 5.0    # reset localmap every 5 m of travel
    localmap_voxel_size: float = 0.5  # downsample before insertion
    method: str = "tpu"               # the reference's MethodType slot for us
    # NDT initial-guess providers (reference launch modes `use_imu`/`use_odom`,
    # odom_node.cpp:237-254,494-663): integrate per-scan IMU / wheel-odometry
    # windows (ops/imu.py) into the guess instead of constant velocity. Both
    # set = ImuOdomCalc (wheel translation + IMU rotation).
    use_imu: bool = False
    use_odom: bool = False
    imu_samples: int = 16             # fixed per-scan sample-window capacity


@dataclass(frozen=True)
class ScanContextConfig:
    """Scan Context descriptor (reference `Scancontext.h:83-104`)."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    lidar_height: float = 2.0       # z offset added before binning
    num_exclude_recent: int = 30
    num_candidates: int = 3         # top-k from ring-key search
    search_ratio: float = 0.1       # ±10% sector shift window
    dist_thresh: float = 0.2        # SC_DIST_THRES (pgo sets 0.2)


@dataclass(frozen=True)
class IscConfig:
    """Intensity Scan Context (reference `ISCGeneration.h:29-43`)."""

    num_ring: int = 60
    num_sector: int = 60
    max_range: float = 40.0
    skip_neighbor_distance: float = 20.0
    inflation_covariance: float = 0.03
    geometry_thresh: float = 0.67
    intensity_thresh: float = 0.91
    ground_z_min: float = -0.9
    ground_z_max: float = 30.0


@dataclass(frozen=True)
class LoopConfig:
    """Loop detection + ICP verification (reference `pgo_node.cpp:299-483`)."""

    method: str = "sc"              # "radius" | "sc" | "isc"
    radius_search: float = 20.0     # kd-tree radius (pgo_node.cpp:318)
    min_time_diff: float = 30.0     # candidate must be ≥30 s older
    max_loop_dist: float = 30.0     # 2-D sanity distance
    submap_half_width: int = 25     # ±25 keyframes around loop target
    icp_max_corr_dist: float = 150.0
    icp_max_iterations: int = 100
    icp_trans_eps: float = 1e-6
    icp_fitness_thresh: float = 0.3
    max_correction: float = 10.0    # reject if ICP moves the relative pose
    # further than this from the odometric initial guess (divergence guard;
    # fitness alone is density-dependent)
    detect_period: int = 2          # run detection every N keyframes (2 Hz analogue)
    submap_points: int = 16384      # fixed submap cloud capacity for ICP
    async_detect: bool = False      # run detect+verify on a worker thread
    # (the reference's LoopClosure/ICPRefine threads, without the mutexes)
    use_sc_yaw: bool = True         # initialize ICP's heading from the SC/ISC
    # rotation estimate instead of the drifted pose difference. The reference
    # computes this yaw (Scancontext.cpp:416-420) and then discards it
    # (pgo_node.cpp:344-363) — a quirk deliberately fixed here: under large
    # heading drift the descriptor's rotation estimate is what lets ICP lock.


@dataclass(frozen=True)
class PgoConfig:
    """Pose-graph optimization (reference `pgo_node.cpp:80-111,498-528`)."""

    keyframe_gap: float = 2.0       # keyframe every 2 m (pgo_node.cpp:54)
    prior_noise: float = 1e-12
    odom_noise_trans: float = 1e-6
    odom_noise_rot: float = 1e-4
    use_gps: bool = False
    gps_noise_xy: float = 1e9       # altitude-only GPS factor
    gps_noise_alt: float = 250.0
    cauchy_k: float = 1.0           # robust kernel scale multiplier on loop fitness
    gn_iterations: int = 8
    cg_iterations: int = 100
    cg_tol: float = 1e-6            # relative PCG stop on the PRECONDITIONED
    # norm: exit when rᵀM⁻¹r < tol·bᵀM⁻¹b (so the effective threshold depends
    # on the chosen `precond`; see pose_graph.solve's cg_cond)
    # per-accepted-loop solve economy (see pose_graph.GraphSpec): warm-started
    # GN iterations for in-run solves, and re-solve cadence in accepted loops
    inloop_gn_iterations: int = 2
    solve_every: int = 1
    precond: str = "tridiag"        # CG preconditioner: "tridiag" | "jacobi"
    max_keyframes: int = 2048       # static capacity of keyframe store
    max_loops: int = 256            # static capacity of accepted loop factors


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout for multi-chip runs."""

    data_axis: str = "data"         # points / candidate parallelism
    kf_axis: str = "kf"             # keyframe-axis sharding (descriptor DB, graph)
    mesh_shape: tuple = ()          # () → single device


@dataclass(frozen=True)
class SlamConfig:
    filter: FilterConfig = field(default_factory=FilterConfig)
    ground: GroundConfig = field(default_factory=GroundConfig)
    ndt: NdtConfig = field(default_factory=NdtConfig)
    odom: OdomConfig = field(default_factory=OdomConfig)
    sc: ScanContextConfig = field(default_factory=ScanContextConfig)
    isc: IscConfig = field(default_factory=IscConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    pgo: PgoConfig = field(default_factory=PgoConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    save_dir: str = "out"
    seed: int = 0

    # ------------------------------------------------------------------ #
    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def override(self, dotted: dict[str, Any]) -> "SlamConfig":
        """Apply {'ndt.resolution': 1.0, ...} style overrides."""
        cfg = self
        for key, val in dotted.items():
            parts = key.split(".")
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: val})
            else:
                sub = getattr(cfg, parts[0])
                sub = dataclasses.replace(sub, **{parts[1]: val})
                cfg = dataclasses.replace(cfg, **{parts[0]: sub})
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, text: str) -> "SlamConfig":
        raw = json.loads(text)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in raw:
                continue
            v = raw[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in _SUBCONFIGS:
                sub_cls = _SUBCONFIGS[f.name]
                if "mesh_shape" in v:
                    v["mesh_shape"] = tuple(v["mesh_shape"])
                kw[f.name] = sub_cls(**v)
            else:
                kw[f.name] = v
        return cls(**kw)


_SUBCONFIGS = {
    "filter": FilterConfig,
    "ground": GroundConfig,
    "ndt": NdtConfig,
    "odom": OdomConfig,
    "sc": ScanContextConfig,
    "isc": IscConfig,
    "loop": LoopConfig,
    "pgo": PgoConfig,
    "parallel": ParallelConfig,
}


def default_config() -> SlamConfig:
    return SlamConfig()


def tiny_config() -> SlamConfig:
    """Small static shapes for CPU tests / dry runs."""
    return SlamConfig(
        filter=FilterConfig(max_raw_points=4096, max_points=2048),
        ndt=NdtConfig(source_points=1024, grid_x=32, grid_y=32, grid_z=12,
                      max_iterations=20),
        loop=LoopConfig(submap_points=2048),
        pgo=PgoConfig(max_keyframes=128, max_loops=16),
    )
