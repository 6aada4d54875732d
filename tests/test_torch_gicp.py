"""The port's GICP (`ops/gicp.py`) and keyframe-window localmaps
(`models/localmap_keyframes.py`) against the JAX reference, on the fixtures
of tests/test_parity_extras.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ndt import build_grid, make_world
from tests.test_parity_extras import GSPEC
from xchu_slam_tpu.models import localmap_keyframes as jlk
from xchu_slam_tpu.ops import gicp as jgicp, voxel_map as jvm
from xchu_slam_tpu.utils import se3 as jse3
from xchu_slam_tpu_torch import convert
from xchu_slam_tpu_torch.models import localmap_keyframes as tlk
from xchu_slam_tpu_torch.ops import gicp as tgicp, voxel_map as tvm

torch.set_num_threads(2)

TSPEC = tvm.GridSpec(*GSPEC)


def _np_tree(t):
    return type(t)(*(np.asarray(a) for a in t))


@pytest.fixture(scope="module")
def fixture():
    """test_gicp_recovers_pose's world, grid and source scan (rng seed 0)."""
    rng = np.random.default_rng(0)
    world = make_world(rng)
    grid = build_grid(world)
    true_pose = np.array([0.3, -0.2, 0.0, 0.0, 0.0, 0.03], np.float32)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(true_pose)))
    sel = world[rng.choice(len(world), 2000, replace=False)]
    src = ((np.linalg.inv(T)[:3, :3] @ sel.T).T + np.linalg.inv(T)[:3, 3]).astype(np.float32)
    return src, grid, convert.voxel_grid_from_ref(_np_tree(grid), TSPEC), true_pose


def test_align_matches_reference(fixture):
    """The same Newton iteration count, the pose within 1e-4, and the pose
    the reference test asks for."""
    src, jgrid, tgrid, true_pose = fixture
    spec_j, spec_t = jgicp.GicpSpec(max_iterations=40), tgicp.GicpSpec(max_iterations=40)
    ref = jgicp.align(jnp.asarray(src), jnp.ones(len(src), bool), jgrid, jnp.zeros(6),
                      GSPEC, spec_j)
    res = tgicp.align(torch.from_numpy(src), torch.ones(len(src), dtype=torch.bool), tgrid,
                      torch.zeros(6), TSPEC, spec_t)
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(ref.pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=1e-5)
    np.testing.assert_allclose(res.pose.numpy()[:2], true_pose[:2], atol=0.1)
    assert abs(float(res.pose[5]) - true_pose[5]) < 0.02


def test_source_covariances_match_reference(fixture):
    src, *_ = fixture
    mask = np.ones(len(src), bool)
    mask[::7] = False
    cj, okj = jgicp.source_covariances(jnp.asarray(src), jnp.asarray(mask), GSPEC)
    ct, okt = tgicp.source_covariances(torch.from_numpy(src), torch.from_numpy(mask), TSPEC)
    assert np.array_equal(okt.numpy(), np.asarray(okj)) and 0 < okt.sum() < len(src)
    scale = np.abs(np.asarray(cj)).max(axis=(1, 2))
    assert (np.abs(ct.numpy() - np.asarray(cj)).max(axis=(1, 2)) <= 1e-5 * scale).all()


def test_loss_gradient_and_hessian_match_reference_with_invalid_lookups(fixture):
    """At a pose that moves part of the source out of the grid and onto
    empty voxels (lookups that are not valid, whose rows the `where` drops),
    the value, gradient and Hessian agree with JAX's autodiff: a NaN in the
    unselected branch would poison both."""
    src, jgrid, tgrid, _ = fixture
    mask = np.ones(len(src), bool)
    pose = np.array([30.0, -4.0, 0.5, 0.02, -0.01, 0.4], np.float32)
    spec_j = jgicp.GicpSpec()
    cov_j, _ = jgicp.source_covariances(jnp.asarray(src), jnp.asarray(mask), GSPEC)
    cov_t, _ = tgicp.source_covariances(torch.from_numpy(src), torch.from_numpy(mask), TSPEC)

    def lj(p):
        return jgicp.gicp_loss(p, jnp.asarray(src), jnp.asarray(mask), cov_j, jgrid, GSPEC,
                               spec_j.cov_epsilon)

    def lt(p):
        return tgicp.gicp_loss(p, torch.from_numpy(src), torch.from_numpy(mask), cov_t, tgrid,
                               TSPEC, spec_j.cov_epsilon)

    pj, pt = jnp.asarray(pose), torch.from_numpy(pose)
    R = np.asarray(jse3.euler_to_matrix(pj[3:6]))
    _, _, valid = jvm.lookup7(jgrid, GSPEC, jnp.asarray(src @ R.T + pose[:3]))
    valid = np.asarray(valid)
    assert valid.any(axis=1).mean() < 0.9 and valid.any()      # some lookups invalid
    Lj, gj = lj(pj), np.asarray(jax.jit(jax.grad(lj))(pj))
    Hj = np.asarray(jax.jit(jax.hessian(lj))(pj))
    gt, Lt = torch.func.grad_and_value(lt)(pt)
    Ht = torch.func.hessian(lt)(pt).numpy()
    for a in (gt.numpy(), Ht):
        assert np.isfinite(a).all()
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-5)
    assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()
    assert np.abs(Ht - Hj).max() <= 1e-4 * np.abs(Hj).max()


# -------------------------------------------------------------- localmaps -- #

def _rel_err(tgrid, jgrid):
    fin_j = convert.unpack_base(np.asarray(jgrid.fin), TSPEC)
    fin_t = tgrid.fin.numpy()
    return np.abs(fin_t - fin_j).max() / max(np.abs(fin_j).max(), 1e-30)


def test_window_localmap_matches_reference(rng):
    """test_window_localmap's keyframes: the last 4 of 6, fin within 1e-4
    relative and the same statistics count."""
    K, P = 16, 1024
    clouds = np.zeros((K, P, 3), np.float32)
    masks = np.zeros((K, P), bool)
    poses = np.zeros((K, 6), np.float32)
    for k in range(6):
        clouds[k] = rng.uniform(-10, 10, (P, 3))
        masks[k] = True
        poses[k, 0] = 2.0 * k
    jg = jlk.build_window_localmap(jnp.asarray(clouds), jnp.asarray(masks), jnp.asarray(poses),
                                   jnp.int32(6), jnp.asarray(poses[5, :3]), GSPEC, window=4)
    tg = tlk.build_window_localmap(torch.from_numpy(clouds), torch.from_numpy(masks),
                                   torch.from_numpy(poses), 6, torch.from_numpy(poses[5, :3]),
                                   TSPEC, window=4)
    assert float(tg.stats[:, 0].sum()) == 4 * P
    assert np.array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert _rel_err(tg, jg) <= 1e-4


def test_distance_localmap_matches_reference(rng):
    """test_distance_localmap's keyframes 10 m apart: the 3 within 25 m of
    the last pose, fin within 1e-4 relative; the count may be a tensor."""
    K, P = 16, 512
    clouds = np.tile(rng.uniform(-5, 5, (1, P, 3)).astype(np.float32), (K, 1, 1))
    masks = np.ones((K, P), bool)
    poses = np.zeros((K, 6), np.float32)
    poses[:, 0] = np.arange(K) * 10.0
    jg = jlk.build_distance_localmap(jnp.asarray(clouds), jnp.asarray(masks),
                                     jnp.asarray(poses), jnp.int32(K),
                                     jnp.asarray(poses[K - 1, :3]), GSPEC, radius=25.0,
                                     max_window=K)
    tg = tlk.build_distance_localmap(torch.from_numpy(clouds), torch.from_numpy(masks),
                                     torch.from_numpy(poses), torch.tensor(K),
                                     torch.from_numpy(poses[K - 1, :3]), TSPEC, radius=25.0,
                                     max_window=K)
    assert float(tg.stats[:, 0].sum()) == 3 * P
    assert _rel_err(tg, jg) <= 1e-4
