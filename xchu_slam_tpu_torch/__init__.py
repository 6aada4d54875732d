"""xchu_slam_tpu_torch — the PyTorch/CUDA port of xchu_slam_tpu.

The same LiDAR SLAM engine (scan filter, NDT odometry over a rolling voxel
grid, Scan Context retrieval, ICP loop verification, pose-graph solve) on
PyTorch tensors, with the reference's one Pallas kernel (the ICP
nearest-neighbour search) rewritten as a CUDA kernel for Hopper. The package
imports torch and numpy only, never jax or `xchu_slam_tpu`.

Every tensor-valued function takes its inputs on one device and returns its
outputs there; the caller picks the device (`torch.device("cuda")` on the
card, the CPU in the tests).
"""

import torch

# Coordinates meet dot products everywhere on this path (the reference pins
# Precision.HIGHEST for the same reason): a TF32 pass keeps ~3 decimal
# digits, which at ±100 m mispicks neighbours by metres.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from xchu_slam_tpu_torch.config import SlamConfig, default_config, tiny_config  # noqa: E402
from xchu_slam_tpu_torch.types import Cloud, VoxelGrid, make_cloud  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SlamConfig",
    "default_config",
    "tiny_config",
    "Cloud",
    "VoxelGrid",
    "make_cloud",
]
