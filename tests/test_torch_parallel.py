"""The port's sharded ops (`xchu_slam_tpu_torch.parallel`, the `mesh=`
branches of ndt / scancontext / isc / icp / pose_graph) on a group of 4
gloo ranks against the JAX package's sharded functions on a 4-device mesh of
the test process's virtual CPU devices, and against the port's own
single-device routes. One rank group runs every case once (the
module-scoped fixture: fresh interpreters joined through a `file://` store,
every wait bounded); the tests compare what it returned. The inputs are made
from seeds with numpy. Tolerances are stated beside each assert."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import mesh_cases
import pgo_cases
from xchu_slam_tpu.models import pose_graph as jpg
from xchu_slam_tpu.ops import icp as jicp, isc as jisc, ndt as jndt, scancontext as jsc
from xchu_slam_tpu.ops import voxel_map as jvm
from xchu_slam_tpu.parallel import sharded as jsharded
from xchu_slam_tpu_torch import convert
from xchu_slam_tpu_torch.models import pose_graph as tpg
from xchu_slam_tpu_torch.ops import icp as ticp, isc as tisc, ndt as tndt
from xchu_slam_tpu_torch.ops import scancontext as tsc, voxel_map as tvm
from xchu_slam_tpu_torch.parallel import distributed
from xchu_slam_tpu_torch.utils import sim

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))

D = 4
GSPEC = jvm.GridSpec(gx=48, gy=48, gz=16, resolution=2.0, min_points=6, eig_inflation=0.01)
NSPEC = jndt.NdtSpec(max_iterations=25)
# the port's NdtSpec holds the reference's fields it runs, in its order
TNSPEC = tndt.NdtSpec(max_iterations=25)
PGSPEC = tpg.GraphSpec(max_keyframes=48, max_loops=8, gn_iterations=4, cg_iterations=60,
                       odom_info_t=1e3, odom_info_r=1e3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ndt_case():
    rng = np.random.default_rng(0)
    n = 6000
    ground = np.c_[rng.uniform(-35, 35, (n // 2, 2)), rng.normal(0, 0.03, n // 2)]
    wall1 = np.c_[rng.uniform(-35, 35, n // 4), np.full(n // 4, 14.0)
                  + rng.normal(0, 0.05, n // 4), rng.uniform(0, 4, n // 4)]
    k = n - n // 2 - n // 4
    wall2 = np.c_[np.full(k, -12.0) + rng.normal(0, 0.05, k), rng.uniform(-35, 35, k),
                  rng.uniform(0, 4, k)]
    world = np.vstack([ground, wall1, wall2]).astype(np.float32)
    jgrid = jvm.finalize(jvm.insert_points(
        jvm.make_grid(GSPEC, jvm.centered_origin(GSPEC, np.zeros(3))), jnp.asarray(world),
        jnp.ones(len(world), bool), GSPEC), GSPEC)
    tgrid = convert.voxel_grid_from_ref(
        type(jgrid)(*(np.asarray(a) for a in jgrid)), tvm.GridSpec(*GSPEC))
    src = world[rng.choice(len(world), 2048, replace=False)]
    mask = np.ones(2048, bool)
    mask[::37] = False
    init = np.array([0.3, -0.2, 0.0, 0.0, 0.0, 0.02], np.float32)
    return jgrid, {"fin": tgrid.fin.numpy(), "origin": tgrid.origin.numpy(),
                   "stats": tgrid.stats.numpy(), "gspec": tuple(GSPEC),
                   "nspec": tuple(TNSPEC), "src": src, "mask": mask, "init": init,
                   "regather_dist": 0.3}


def _sc_case():
    spec = tsc.ScSpec()
    world = sim.make_world(2, extent=90.0)
    g = np.random.default_rng(1)
    K = 64
    db = np.zeros((K, spec.num_ring, spec.num_sector), np.float32)
    for i in range(40):
        p = np.array([25 * np.cos(i), 25 * np.sin(1.7 * i), 0, 0, 0, 0.3 * i], np.float32)
        xyz, _ = sim.render_scan(world, p, g, n_points=6000)
        db[i] = tsc.make_descriptor(_t(xyz), torch.ones(len(xyz), dtype=torch.bool), spec).numpy()
    p5 = np.array([25 * np.cos(5), 25 * np.sin(8.5), 0, 0, 0, 1.5 + np.pi / 2], np.float32)
    xyz, _ = sim.render_scan(world, p5, g, n_points=6000)
    xyz = xyz[:5996].astype(np.float32)       # a multiple of D points
    xyz_mask = np.ones(len(xyz), bool)
    xyz_mask[::11] = False
    q = tsc.make_descriptor(_t(xyz), _t(xyz_mask), spec).numpy()
    # the rotated revisit of keyframe 5, a query with no match, and the
    # newest keyframe's own descriptor at two database counts
    queries = [q, np.zeros_like(q), db[39], db[39]]
    counts = [40, 40, 40, 36]
    return {"spec": tuple(spec), "db": db, "queries": queries, "counts": counts,
            "xyz": xyz, "xyz_mask": xyz_mask}


def _isc_case():
    """A half circuit of 12 scans and 4 revisits of scans 1..4 a little off
    their pose and turned, in a store of capacity 24
    (tests/test_torch_isc.py's store)."""
    K = 24
    world = sim.make_world(17, extent=60.0)
    rng = np.random.default_rng(17)
    gt = sim.loop_trajectory(12, radius=10.0, speed=3.0)
    gt = np.vstack([gt, gt[1:5] + np.array([0.15, -0.1, 0, 0, 0, 0.45], np.float32)])
    spec = tisc.IscSpec()
    db = np.zeros((K, spec.num_ring, spec.num_sector), np.float32)
    for k, p in enumerate(gt):
        xyz, inten = sim.render_scan(world, p, rng, n_points=6000, max_range=45.0)
        db[k] = tisc.make_descriptor(_t(xyz), _t(inten), torch.ones(len(xyz), dtype=torch.bool),
                                     spec).numpy()
    positions = np.zeros((K, 3), np.float32)
    positions[:len(gt)] = gt[:, :3] - gt[0, :3]
    step = np.linalg.norm(np.diff(positions[:12, :2], axis=0), axis=1)
    travel = np.zeros(K, np.float32)
    travel[1:12] = np.cumsum(step)
    travel[12:16] = travel[11] + 3.0 * np.arange(1, 5) + 30.0
    counts = [16, 15, 14, 13, 8, 1]
    return {"spec": tuple(spec), "db": db, "positions": positions, "travel": travel,
            "queries": [db[c - 1] for c in counts], "counts": counts}


def _icp_case():
    world = sim.make_world(12, extent=60.0)
    rng = np.random.default_rng(12)
    gt = sim.loop_trajectory(12, radius=15.0, speed=1.0)
    from xchu_slam_tpu_torch.utils import se3

    T = se3.pose_to_matrix(_t(np.asarray(gt, np.float32))).numpy()
    sub = []
    for k in range(2, 10):
        xyz = sim.render_scan(world, gt[k], rng, n_points=2000)[0]
        rel = np.linalg.inv(T[6]) @ T[k]
        sub.append(xyz @ rel[:3, :3].T + rel[:3, 3])
    tgt = np.vstack(sub).astype(np.float32)
    tgt = tgt[rng.choice(len(tgt), 4096, replace=False)]
    src = sim.render_scan(world, gt[7], rng, n_points=1024)[0][:1024].astype(np.float32)
    src = np.pad(src, ((0, 1024 - len(src)), (0, 0)))
    smask = np.ones(1024, bool)
    smask[1000:] = False
    off = se3.pose_to_matrix(_t(np.array([0.3, -0.25, 0.0, 0.0, 0.0, 0.05], np.float32)))
    init = ((np.linalg.inv(T[6]) @ T[7]) @ off.numpy()).astype(np.float32)
    return {"args": (src, smask, tgt, np.ones(4096, bool), init),
            "spec": tuple(ticp.IcpSpec())}


def _pgo_case():
    poses, graph = pgo_cases.chain_graph(K=48, L=8, n_live=40, gps=True)
    # the chain's poses off their odometry, so that its gradient is not 0
    noisy = poses + np.random.default_rng(4).normal(0, 0.05, poses.shape).astype(np.float32)
    return {"poses": poses, "noisy": noisy, "graph": tuple(t.numpy() for t in graph),
            "spec": tuple(PGSPEC)}


def _superstep_case(ndt_case):
    spec = tsc.ScSpec(num_exclude_recent=4)
    rng = np.random.default_rng(3)
    K = 32
    db = rng.uniform(0, 2, (K, spec.num_ring, spec.num_sector)).astype(np.float32)
    desc = tsc.make_descriptor(_t(ndt_case["src"]), _t(ndt_case["mask"]), spec).numpy()
    db[3] = np.roll(desc, 7, axis=1)        # the scan's descriptor, turned, at index 3
    return {"spec": tuple(spec), "db": db, "count": K, "desc": desc}


@pytest.fixture(scope="module")
def cases():
    jgrid, ndt_case = _ndt_case()
    c = {"ndt": ndt_case, "sc": _sc_case(), "isc": _isc_case(), "icp": _icp_case(),
         "pgo": _pgo_case()}
    c["superstep"] = _superstep_case(ndt_case)
    c["jgrid"] = jgrid
    return c


@pytest.fixture(scope="module")
def ranks(cases):
    """Every rank's results: one group of D gloo ranks runs all the cases."""
    args = {k: v for k, v in cases.items() if k != "jgrid"}
    return distributed.launch(D, "mesh_cases:parallel_cases", (args,), timeout_s=240,
                              path=(HERE,))


@pytest.fixture(scope="module")
def jmesh():
    return jsharded.make_mesh(D)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_every_rank_returns_rank_0s_bits(ranks):
    """The decisions are taken from reduced sums that are the same bits on
    every rank, so every output is too."""
    assert len(ranks) == D
    for r in range(1, D):
        assert _same(ranks[r], ranks[0]), r


def _replicated(fn, mesh, n_args):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(),) * n_args, out_specs=P(),
                             check_vma=False))


def test_sharded_ndt_matches_jax_and_single_device(cases, ranks, jmesh):
    """Against the JAX package's mesh branch of its align (`ndt.align` with
    `axis`, inside a replicated-input `shard_map`: the closed-form passes
    whose sums it reduces, as the port's) and the port's single-device
    align: the same iteration count, the pose within 1e-4 (the bound of the
    single-device NDT parity test, tests/test_torch_ndt.py). The JAX
    package's `sharded_ndt_align` differentiates its loss by autodiff
    instead (7 Newton iterations here where the closed form takes 6, ending
    1e-2 m away): it is held, as the reference's own test holds it, to the
    true pose within 0.05 m in x and y, 0.12 m in z and 0.02 rad. Each pass
    is one collective: at least two a Newton iteration."""
    c, got = cases["ndt"], ranks[0]["ndt"]
    args = (cases["jgrid"], jnp.asarray(c["src"]), jnp.asarray(c["mask"]),
            jnp.asarray(c["init"]))
    j = _replicated(lambda *a: jndt.align(*a, GSPEC, NSPEC, axis="data"), jmesh, 4)(*args)
    assert int(got["iterations"]) == int(j.iterations)
    np.testing.assert_allclose(got["pose"], np.asarray(j.pose), atol=1e-4)
    one = tndt.align(mesh_cases._grid(c), _t(c["src"]), _t(c["mask"]), _t(c["init"]),
                     tvm.GridSpec(*c["gspec"]), TNSPEC)
    assert int(got["iterations"]) == int(one.iterations)
    np.testing.assert_allclose(got["pose"], one.pose.numpy(), atol=1e-4)
    # fitness sums from the shards: the matched fraction's counts are exact,
    # the mean distance within float32 rounding of another summation order
    np.testing.assert_allclose(got["matched_frac"], one.matched_frac.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["fitness"], one.fitness.numpy(), rtol=1e-4)
    assert got["collectives"] >= 2 * int(got["iterations"])
    pose, _iters, _conv = jsharded.sharded_ndt_align(jmesh, *args, GSPEC, NSPEC)
    for p_ in (got["pose"], np.asarray(pose)):
        np.testing.assert_allclose(p_[[0, 1]], 0.0, atol=0.05)
        np.testing.assert_allclose(p_[2], 0.0, atol=0.12)
        np.testing.assert_allclose(p_[3:], 0.0, atol=0.02)


def test_sharded_ndt_with_a_frozen_neighbourhood_matches_jax_and_single_device(
        cases, ranks, jmesh):
    """The same align with `regather_dist` 0.3 (the neighbourhood gathered
    again only past 0.3 of motion; the CPU ranks' `newton_align` keeps the
    gather pose, a CUDA rank's shard pass gathers at it): against the JAX
    package's mesh branch and the port's single-device align, the same
    iteration count and convergence and the pose within 1e-4."""
    c, got = cases["ndt"], ranks[0]["ndt_regather"]
    args = (cases["jgrid"], jnp.asarray(c["src"]), jnp.asarray(c["mask"]),
            jnp.asarray(c["init"]))
    jspec = NSPEC._replace(regather_dist=c["regather_dist"])
    j = _replicated(lambda *a: jndt.align(*a, GSPEC, jspec, axis="data"), jmesh, 4)(*args)
    one = tndt.align(mesh_cases._grid(c), _t(c["src"]), _t(c["mask"]), _t(c["init"]),
                     tvm.GridSpec(*c["gspec"]),
                     TNSPEC._replace(regather_dist=c["regather_dist"]))
    for ref in (j, one):
        assert int(got["iterations"]) == int(ref.iterations)
        assert bool(got["converged"]) == bool(ref.converged)
        np.testing.assert_allclose(got["pose"], np.asarray(ref.pose), atol=1e-4)


def _jsc(c, q, count, jmesh):
    spec = jsc.ScSpec(*c["spec"])
    return jsharded.sharded_sc_detect(jmesh, jnp.asarray(q), jnp.asarray(c["db"]), count,
                                      spec)


def test_sharded_sc_detect_matches_jax_and_single_device(cases, ranks, jmesh):
    """idx and found exact, dist within 1e-5 of the JAX package's
    `sharded_sc_detect` and of the port's single-device retrieval."""
    c = cases["sc"]
    spec = tsc.ScSpec(*c["spec"])
    found_any = False
    for got, q, count in zip(ranks[0]["sc"], c["queries"], c["counts"]):
        j = _jsc(c, q, count, jmesh)
        one = tsc.detect_loop_on_device(_t(q), _t(c["db"]), count, spec)
        for want in (j, one):
            assert bool(got["found"]) == bool(want.found)
            assert int(got["idx"]) == int(want.idx)
            if np.isfinite(float(want.dist)):
                assert abs(float(got["dist"]) - float(want.dist)) <= 1e-5
            else:
                assert not np.isfinite(float(got["dist"]))
        np.testing.assert_allclose(got["yaw"], one.yaw.numpy(), atol=1e-6)
        found_any |= bool(got["found"])
    assert found_any


def test_descriptor_from_partials_is_make_descriptor(cases, ranks):
    """`descriptor_partial` on each rank's points + an all-gather max +
    `finalize_descriptor` equals `make_descriptor` on the whole cloud, bit
    for bit (a max is exact in any order)."""
    c = cases["sc"]
    want = tsc.make_descriptor(_t(c["xyz"]), _t(c["xyz_mask"]), tsc.ScSpec(*c["spec"]))
    assert np.array_equal(ranks[0]["desc"], want.numpy())
    j = jsc.make_descriptor(jnp.asarray(c["xyz"]), jnp.asarray(c["xyz_mask"]),
                            jsc.ScSpec(*c["spec"]))
    assert np.array_equal(ranks[0]["desc"], np.asarray(j))


def test_sharded_isc_detect_matches_jax_and_single_device(cases, ranks, jmesh):
    """The reference's `isc.detect_loop(axis=...)` inside a replicated-input
    `shard_map` and the port's single-device route: idx and found exact,
    score within 1e-5."""
    c = cases["isc"]
    spec = tisc.IscSpec(*c["spec"])
    jspec = jisc.IscSpec(*c["spec"])
    found_any = False
    for got, q, count in zip(ranks[0]["isc"], c["queries"], c["counts"]):
        f = _replicated(lambda q_, db, pos, tr: jisc.detect_loop(
            q_, db, jnp.int32(count), pos, tr, jspec, axis="data"), jmesh, 4)
        j = f(jnp.asarray(q), jnp.asarray(c["db"]), jnp.asarray(c["positions"]),
              jnp.asarray(c["travel"]))
        one = tisc.detect_loop_on_device(_t(q), _t(c["db"]), count, _t(c["positions"]),
                                         _t(c["travel"]), spec)
        for want in (j, one):
            assert bool(got["found"]) == bool(want.found)
            assert int(got["idx"]) == int(want.idx)
            assert abs(float(got["score"]) - float(want.score)) <= 1e-5
        found_any |= bool(got["found"])
    assert found_any


def test_sharded_icp_matches_jax_and_single_device(cases, ranks, jmesh):
    """Against the reference's `icp.align(axis=...)` inside a
    replicated-input `shard_map`: the same iteration count, T within 1e-3 m
    and 1e-4 in rotation (the bounds of the single-device ICP parity test,
    tests/test_torch_loop.py); against the port's single-device route: the
    same iteration count, T within 1e-5. Two collectives a trip (the means,
    then the centred cross-covariance) and one for the fitness."""
    c, got = cases["icp"], ranks[0]["icp"]
    f = _replicated(lambda *a: jicp.align(*a, jicp.IcpSpec(*c["spec"]), axis="data"),
                    jmesh, 5)
    j = f(*(jnp.asarray(a) for a in c["args"]))
    Tj = np.asarray(j.T)
    assert int(got["iterations"]) == int(j.iterations)
    assert bool(got["converged"]) == bool(j.converged)
    assert np.abs(got["T"][:3, 3] - Tj[:3, 3]).max() <= 1e-3
    assert np.abs(got["T"][:3, :3] - Tj[:3, :3]).max() <= 1e-4
    one = ticp.align(*(_t(a) for a in c["args"]), ticp.IcpSpec(*c["spec"]))
    assert int(got["iterations"]) == int(one.iterations)
    np.testing.assert_allclose(got["T"], one.T.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["fitness"], one.fitness.numpy(), rtol=1e-4)
    assert got["collectives"] == 2 * int(got["iterations"]) + 1


def _jgraph(c):
    return jpg.GraphData(*(jnp.asarray(a) for a in convert.graph_to_ref(
        tpg.GraphData(*(_t(a) for a in c["graph"]))).values()))


def test_sharded_pgo_gradient_demo_matches_jax(cases, ranks, jmesh):
    """The between factors' gradient summed over the shards against the JAX
    package's `sharded_pgo_hvp_demo`: within 1e-4 of its largest entry
    (float32 Jacobians of a chain at information 1e3)."""
    c = cases["pgo"]
    want = np.asarray(jsharded.sharded_pgo_hvp_demo(
        jmesh, jnp.asarray(c["noisy"]), _jgraph(c), jpg.GraphSpec(*c["spec"])))
    got = ranks[0]["pgo_demo"]
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert not got[0].any()               # node 0 is gauge-fixed


def test_sharded_pgo_solve_matches_jax_and_single_device(cases, ranks, jmesh):
    """At the circuit's spec (odometry information 1e3): the optimized poses
    within 1e-4 of the JAX package's `sharded_pgo_solve` and of the port's
    single-device solve (the same mathematics summed in another order: the
    reference reduces the Hessian-vector product every CG iteration, the
    port gathers the factors' blocks once a Gauss-Newton iteration). Two
    collectives a Gauss-Newton iteration."""
    c, got = cases["pgo"], ranks[0]["pgo"]
    want = np.asarray(jsharded.sharded_pgo_solve(
        jmesh, jnp.asarray(c["poses"]), _jgraph(c), jpg.GraphSpec(*c["spec"])))
    one = tpg.solve(_t(c["poses"]), mesh_cases._graph(c), PGSPEC).numpy()
    assert np.abs(want - c["poses"]).max() > 1e-2            # the solve moved the chain
    np.testing.assert_allclose(got["poses"], want, atol=1e-4)
    np.testing.assert_allclose(got["poses"], one, atol=1e-4)
    assert np.array_equal(got["poses"][40:], c["poses"][40:])    # dead keyframes untouched
    assert got["collectives"] == 2 * PGSPEC.gn_iterations


def test_slam_superstep_matches_its_components(cases, ranks):
    """`slam_superstep` is its components: the align and the solve bit for
    bit as the sharded ops alone, the descriptor equal to `make_descriptor`
    on the whole scan, the planted turned copy of it retrieved at index 3
    with the planted shift."""
    s, r = ranks[0]["superstep"], ranks[0]
    c = cases["superstep"]
    assert np.array_equal(s["pose"], r["ndt"]["pose"])
    assert s["iterations"] == int(r["ndt"]["iterations"])
    assert np.array_equal(s["opt"], r["pgo"]["poses"])
    assert np.array_equal(s["desc"], c["desc"])
    dist, idx, shift = s["cand"]
    assert int(idx) == 3 and dist < tsc.ScSpec(*c["spec"]).dist_thresh
    assert (-int(shift)) % tsc.ScSpec().num_sector == 7


def test_a_shard_that_does_not_divide_is_refused_by_name():
    mesh = distributed.Mesh(group=None, rank=0, size=3, backend="gloo",
                            device=torch.device("cpu"))
    with pytest.raises(ValueError, match="source points: leading axis 1000 is not "
                                         "divisible by the mesh size 3"):
        mesh.shard(1000, "source points")
    g = tvm.GridSpec(*GSPEC)
    with pytest.raises(ValueError, match="source points"):
        tndt.align(None, torch.zeros(1000, 3), torch.ones(1000, dtype=torch.bool),
                   torch.zeros(6), g, TNSPEC, mesh=mesh)
    with pytest.raises(ValueError, match="keyframe slots"):
        tpg.solve(torch.zeros(40, 6), tpg.empty_graph(tpg.GraphSpec(40, 9)), PGSPEC,
                  mesh=mesh)
