"""The port's foundations against the JAX reference: config, simulator,
metrics, SE(3) and small linear algebra, and the port's import boundary.

Inputs are made with numpy from fixed seeds and fed to both packages."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xchu_slam_tpu import config as jconfig
from xchu_slam_tpu.utils import linalg as jlinalg, metrics as jmetrics, se3 as jse3, sim as jsim
from xchu_slam_tpu_torch import config as tconfig
from xchu_slam_tpu_torch.utils import linalg as tlinalg, metrics as tmetrics, se3 as tse3, sim as tsim

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_matches_reference():
    for name in ("default_config", "tiny_config"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())
    over = {"ndt.resolution": 1.0, "loop.method": "radius"}
    assert dataclasses.asdict(tconfig.default_config().override(over)) == \
        dataclasses.asdict(jconfig.default_config().override(over))


def test_sim_world_and_trajectories_identical():
    wj, wt = jsim.make_world(3, extent=60.0), tsim.make_world(3, extent=60.0)
    assert np.array_equal(wj.xyz, wt.xyz) and np.array_equal(wj.intensity, wt.intensity)
    assert np.array_equal(jsim.loop_trajectory(50, radius=20.0, speed=1.1),
                          tsim.loop_trajectory(50, radius=20.0, speed=1.1))
    assert np.array_equal(jsim.closed_lap_trajectory(40, radius=30.0),
                          tsim.closed_lap_trajectory(40, radius=30.0))


@pytest.mark.parametrize("with_index", [False, True])
def test_rendered_scans_bit_identical(with_index):
    wj, wt = jsim.make_world(4, extent=60.0), tsim.make_world(4, extent=60.0)
    ij = jsim.WorldIndex(wj) if with_index else None
    it = tsim.WorldIndex(wt) if with_index else None
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for p in tsim.loop_trajectory(4, radius=20.0):
        a = jsim.render_scan(wj, p, rj, n_points=3000, index=ij)
        b = tsim.render_scan(wt, p, rt, n_points=3000, index=it)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_metrics_match_reference():
    rng = np.random.default_rng(1)
    gt = np.cumsum(rng.normal(size=(40, 3)), 0)
    est = gt + rng.normal(scale=0.1, size=gt.shape)
    for align in (True, False):
        assert tmetrics.ape_rmse(est, gt, align) == jmetrics.ape_rmse(est, gt, align)
    assert tmetrics.end_drift(est, gt) == jmetrics.end_drift(est, gt)
    st = np.arange(10) * 0.2
    a, b = tmetrics.associate(st, np.arange(30) * 0.1), jmetrics.associate(st, np.arange(30) * 0.1)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ---------------------------------------------------------------- se3 ---- #

def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    p = np.c_[rng.uniform(-100, 100, (n, 3)), rng.uniform(-3.0, 3.0, (n, 3))]
    p[:, 4] = np.clip(p[:, 4], -1.4, 1.4)   # keep pitch off the gimbal lock
    return p.astype(np.float32)


def test_se3_pose_matrix_roundtrip_matches_reference():
    p = _poses(64)
    Tj = np.asarray(jse3.pose_to_matrix(jnp.asarray(p)))
    Tt = tse3.pose_to_matrix(_t(p))
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=1e-6 * 100)
    np.testing.assert_allclose(tse3.matrix_to_pose(Tt).numpy(),
                               np.asarray(jse3.matrix_to_pose(jnp.asarray(Tj))), atol=1e-4)
    # rotation part at unit scale: 1e-6
    np.testing.assert_allclose(Tt[:, :3, :3].numpy(), Tj[:, :3, :3], atol=1e-6)
    Ij = np.asarray(jse3.inverse(jnp.asarray(Tj)))
    np.testing.assert_allclose(tse3.inverse(Tt).numpy(), Ij, atol=1e-6 * 100)
    Cj = np.asarray(jse3.compose(jnp.asarray(Tj[:32]), jnp.asarray(Tj[32:])))
    np.testing.assert_allclose(tse3.compose(Tt[:32], Tt[32:]).numpy(), Cj, atol=1e-6 * 200)


def test_se3_transform_and_wrap_match_reference():
    p = _poses(4, seed=1)
    pts = np.random.default_rng(2).uniform(-50, 50, (100, 3)).astype(np.float32)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(p[0])))
    np.testing.assert_allclose(tse3.transform_points(_t(T), _t(pts)).numpy(),
                               np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6 * 150)
    np.testing.assert_allclose(tse3.rotate_translate(_t(p[1]), _t(pts)).numpy(),
                               np.asarray(jse3.rotate_translate(jnp.asarray(p[1]), jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6 * 150)
    a = np.linspace(-10, 10, 101).astype(np.float32)
    np.testing.assert_allclose(tse3.wrap_angle(_t(a)).numpy(),
                               np.asarray(jse3.wrap_angle(jnp.asarray(a))), atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-6, 0.0])
def test_se3_exp_log_match_reference(scale):
    """Including the small-angle branches (θ² < 1e-8 and θ < 1e-4)."""
    xi = (np.random.default_rng(3).normal(size=(50, 6)) * scale).astype(np.float32)
    Ej = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Et = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(Et.numpy(), Ej, atol=1e-6)
    np.testing.assert_allclose(tse3.se3_log(Et).numpy(),
                               np.asarray(jse3.se3_log(jnp.asarray(Ej))), atol=1e-5)


# ------------------------------------------------------------- linalg ---- #

def _sym(lam, seed=0):
    """Symmetric float32 matrices Q·diag(lam)·Qᵀ."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(len(lam), 3, 3)))
    A = np.einsum("nij,nj,nkj->nik", q, lam, q)
    return (0.5 * (A + A.transpose(0, 2, 1))).astype(np.float32)


def test_sym6_helpers_and_inv3_match_reference():
    A = _sym(np.random.default_rng(4).uniform(0.5, 3.0, (100, 3)))
    s6 = np.asarray(jlinalg.mat_to_sym6(jnp.asarray(A)))
    assert np.array_equal(tlinalg.mat_to_sym6(_t(A)).numpy(), s6)
    assert np.array_equal(tlinalg.sym6_to_mat(_t(s6)).numpy(),
                          np.asarray(jlinalg.sym6_to_mat(jnp.asarray(s6))))
    v = np.random.default_rng(5).normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(tlinalg.sym6_matvec(_t(s6), _t(v)).numpy(),
                               np.asarray(jlinalg.sym6_matvec(jnp.asarray(s6), jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlinalg.inv3(_t(A)).numpy(),
                               np.asarray(jlinalg.inv3(jnp.asarray(A))), rtol=1e-6, atol=1e-6)
    # a singular matrix inverts to zeros in both
    Z = np.zeros((1, 3, 3), np.float32)
    assert np.array_equal(tlinalg.inv3(_t(Z)).numpy(), np.asarray(jlinalg.inv3(jnp.asarray(Z))))


_N = 400
_EIG_CASES = {
    "distinct": np.random.default_rng(6).uniform(0.1, 3.0, (_N, 3)),
    "near_pair_low": np.c_[np.ones(_N), 1 + np.random.default_rng(7).uniform(0, 1e-6, _N),
                           2 * np.ones(_N)],
    "near_pair_high": np.c_[0.5 * np.ones(_N), 2 * np.ones(_N),
                            2 + np.random.default_rng(8).uniform(0, 1e-6, _N)],
    "exact_pair": np.c_[np.ones(_N), np.ones(_N), 3 * np.ones(_N)],
    "near_isotropic": 1 + np.random.default_rng(9).uniform(0, 1e-7, (_N, 3)),
    "flat_voxel": np.c_[1e-4 * np.ones(_N), np.random.default_rng(10).uniform(0.5, 2, (_N, 2))],
}


@pytest.mark.parametrize("case", sorted(_EIG_CASES))
def test_sym_eigvals3_matches_reference(case):
    """The trigonometric solver agrees with the reference to 1e-6 wherever
    arccos is well conditioned (|r| ≤ 0.9). Near repeated eigenvalues r
    reaches ±1, the clamp decides, and d(acos)/dr is unbounded: there the
    two implementations (whose 9-term sums round in different orders) are
    each held to float64 truth within 2e-4 of the largest eigenvalue, the
    float32 accuracy of the method itself (the reference meets the same
    bound, which the test checks too)."""
    A = _sym(_EIG_CASES[case], seed=11)
    lj = np.asarray(jlinalg.sym_eigvals3(jnp.asarray(A)))
    lt = tlinalg.sym_eigvals3(_t(A)).numpy()
    truth = np.linalg.eigvalsh(A.astype(np.float64))
    assert np.all(np.diff(lt, axis=-1) >= -1e-6)          # ascending
    # r of the trigonometric method, in float64
    A64 = A.astype(np.float64)
    q = np.trace(A64, axis1=1, axis2=2) / 3
    Aq = A64 - q[:, None, None] * np.eye(3)
    p = np.sqrt(np.maximum((Aq ** 2).sum((1, 2)) / 6, 1e-12))
    r = np.linalg.det(Aq / p[:, None, None]) / 2
    well = np.abs(r) <= 0.9
    np.testing.assert_allclose(lt[well], lj[well], rtol=1e-6, atol=1e-6)
    bound = 2e-4 * np.abs(truth).max(axis=1, keepdims=True)
    assert np.all(np.abs(lj - truth) <= bound)
    assert np.all(np.abs(lt - truth) <= bound)


@pytest.mark.parametrize("case", sorted(_EIG_CASES))
def test_inflate_and_invert_cov_matches_reference(case):
    """The conditioned inverse covariance the NDT map uses. Relative to the
    largest entry: 1e-6 unless the eigenvalue floor is active (flat_voxel),
    where the floor inherits the eigenvalues' conditioning."""
    A = _sym(_EIG_CASES[case], seed=12)
    ij = np.asarray(jlinalg.inflate_and_invert_cov(jnp.asarray(A), 0.01))
    it = tlinalg.inflate_and_invert_cov(_t(A), 0.01).numpy()
    scale = np.abs(ij).max(axis=(1, 2), keepdims=True)
    tol = 1e-3 if case == "flat_voxel" else 1e-6
    assert (np.abs(it - ij) / scale).max() <= tol


# ------------------------------------------------------ import boundary -- #

PORT_MODULES = [
    "cli", "config", "convert", "types",
    "io.export", "io.kitti", "io.native_loader", "io.prefetch", "io.procsource",
    "models.async_worker", "models.batch_odometry", "models.continue_session",
    "models.device_pipeline", "models.localmap_keyframes", "models.odometry",
    "models.pipeline", "models.pose_graph", "models.relocalize",
    "ops.filter", "ops.gicp", "ops.ground", "ops.icp", "ops.imu", "ops.isc", "ops.ndt",
    "ops.ndt_deriv",
    "ops.scancontext", "ops.voxel_map", "ops.cuda._build", "ops.cuda.guess_kernel",
    "ops.cuda.icp_kernel", "ops.cuda.ndt_kernel", "ops.cuda.nn_kernel", "ops.cuda.pgo_kernel",
    "parallel.distributed", "parallel.sharded",
    "utils.checkpoint", "utils.collectives", "utils.linalg", "utils.metrics",
    "utils.profiling", "utils.scatter", "utils.se3", "utils.sim",
]


def test_port_imports_neither_jax_nor_reference():
    """Import every module of the port in a fresh interpreter in which
    `jax` and `xchu_slam_tpu` cannot be imported; the modules found are
    exactly the list above (a new module joins the list, and this check)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['xchu_slam_tpu'] = None\n"
        "import xchu_slam_tpu_torch as pkg\n"
        "names = []\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'xchu_slam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    if not m.ispkg:\n"
        "        names.append(m.name.split('.', 1)[1])\n"
        "bad = [n for n in sys.modules if n == 'jax' and sys.modules[n] is not None\n"
        "       or n.startswith(('jax.', 'jaxlib', 'xchu_slam_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(names)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == sorted(PORT_MODULES)


def test_port_sources_name_neither_jax_nor_reference():
    """Imports made inside functions run only when the function does, so the
    sources are read too: no module of the port, and not chip_smoke.py, has
    an import statement of `jax` or of the reference package."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|xchu_slam_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "xchu_slam_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > len(PORT_MODULES)
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
