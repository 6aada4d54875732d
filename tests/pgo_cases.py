"""Pose graphs made from a seed with numpy and the port's se3, shared by the
CPU tests, the card tests and `chip_smoke.py`: a drifting chain of `n_live`
keyframes on a circle in a store of capacity K, loop factors that pull it
back to the truth, and altitude factors. Arrays in the port's layout (int64
loop indices); `convert.graph_to_ref` gives the reference's."""

import numpy as np
import torch

from xchu_slam_tpu_torch.models import pose_graph as tpg
from xchu_slam_tpu_torch.utils import se3


def _mat(poses6: np.ndarray) -> np.ndarray:
    return se3.pose_to_matrix(torch.from_numpy(np.asarray(poses6, np.float32))).numpy()


def chain_graph(K: int = 48, L: int = 6, n_live: int = 40, n_loops: int | None = None,
                gps: bool = False, seed: int = 0, radius: float = 10.0):
    """(poses6 [K,6] float32, GraphData of CPU tensors). Loops join the first
    keyframes to the last ones; the last loop slot of n_loops = L - 1 stays
    masked."""
    rng = np.random.default_rng(seed)
    n_loops = L - 1 if n_loops is None else n_loops
    ang = np.linspace(0, 2 * np.pi, n_live)
    truth = np.zeros((K, 6), np.float32)
    truth[:n_live, 0] = radius * np.cos(ang)
    truth[:n_live, 1] = radius * np.sin(ang)
    truth[:n_live, 5] = ang + np.pi / 2
    T = _mat(truth)
    Z = np.einsum("kab,kbc->kac", np.linalg.inv(T[:-1]), T[1:])
    noise = _mat(rng.normal(size=(K - 1, 6)).astype(np.float32)
                 * [0.02, 0.02, 0.01, 0.002, 0.002, 0.01])
    Zn = np.einsum("kab,kbc->kac", Z, noise)
    est = [T[0]]
    for k in range(n_live - 1):
        est.append(est[-1] @ Zn[k])
    poses = np.zeros((K, 6), np.float32)
    poses[:n_live] = se3.matrix_to_pose(torch.from_numpy(np.stack(est).astype(np.float32))).numpy()
    g = tpg.empty_graph(tpg.GraphSpec(max_keyframes=K, max_loops=L))
    between = g.between_T.numpy().copy()
    between[1:n_live] = Zn[:n_live - 1]
    li = np.zeros(L, np.int64)
    lj = np.zeros(L, np.int64)
    li[:n_loops] = rng.integers(0, 5, n_loops)
    lj[:n_loops] = rng.integers(n_live - 6, n_live, n_loops)
    lT = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    lT[:n_loops] = np.einsum("kab,kbc->kac", np.linalg.inv(T[li[:n_loops]]),
                             T[lj[:n_loops]])
    gps_mask = (rng.random(K) < 0.3) & (np.arange(K) < n_live) if gps else np.zeros(K, bool)
    graph = tpg.GraphData(
        between_T=torch.from_numpy(between.astype(np.float32)),
        kf_mask=torch.from_numpy(np.arange(K) < n_live),
        loop_i=torch.from_numpy(li), loop_j=torch.from_numpy(lj),
        loop_T=torch.from_numpy(lT.astype(np.float32)),
        loop_info=torch.from_numpy(rng.uniform(1.0, 5.0, L).astype(np.float32)),
        loop_mask=torch.from_numpy(np.arange(L) < n_loops),
        gps_alt=torch.from_numpy((truth[:, 2] + 0.1).astype(np.float32)),
        gps_mask=torch.from_numpy(gps_mask))
    return poses, graph


def to_device(graph, device):
    return tpg.GraphData(*(t.to(device) for t in graph))
