"""Rank bodies of the multi-rank tests: each runs on every rank of a group
that `xchu_slam_tpu_torch.parallel.distributed.launch` starts (fresh
interpreters that import torch and the port, never JAX), computes its cases
on the mesh and returns numpy results, which the test process compares with
the JAX package and with the port's single-device routes. The inputs arrive
as numpy arrays made from a seed in the test process."""

import numpy as np
import torch

from xchu_slam_tpu_torch.models import pose_graph as pg
from xchu_slam_tpu_torch.ops import icp, isc, ndt, scancontext as sc, voxel_map as vm
from xchu_slam_tpu_torch.parallel import sharded
from xchu_slam_tpu_torch.types import VoxelGrid
from xchu_slam_tpu_torch.utils import collectives


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, tuple):
        return type(x)(*(_np(a) for a in x)) if hasattr(x, "_fields") else tuple(map(_np, x))
    return x


def _count(fn):
    """(fn's result, the collectives it executed)."""
    before = collectives.collectives
    out = fn()
    return out, collectives.collectives - before


def collectives_cases(mesh, L, g, H, n, big):
    """The packed reductions on rank r's leaves (L, g[r], H[r], n[r]): packed
    against per-leaf, an integer leaf, rank 0's broadcast, max and gather."""
    r = mesh.rank
    leaves = (_t(L), _t(g[r]), _t(H[r]), _t(n[r]))
    packed, c_packed = _count(lambda: collectives.shard_allsum(leaves, mesh))
    per_leaf, c_per_leaf = _count(
        lambda: tuple(collectives.shard_allsum(x, mesh) for x in leaves[:3]))
    exact = collectives.shard_allsum((_t(big), torch.ones(2)), mesh)
    bcast = collectives.shard_bcast0((_t(g[r]), _t(H[r])), mesh)
    amax = collectives.shard_allmax(_t(H[r]), mesh)
    gathered = collectives.shard_allgather((_t(g[r])[None], _t(n[r])[None]), mesh)
    return {"packed": _np(packed), "per_leaf": _np(per_leaf), "c_packed": c_packed,
            "c_per_leaf": c_per_leaf, "exact": _np(exact), "bcast": _np(bcast),
            "amax": _np(amax), "gathered": _np(gathered)}


def failing_rank(mesh):
    """Rank 1 exits with code 3; the others return."""
    if mesh.rank == 1:
        raise SystemExit(3)
    return mesh.rank


def hanging_rank(mesh):
    """Rank 1 never returns within the test's bound."""
    if mesh.rank == 1:
        import time

        time.sleep(600)
    return mesh.rank


def _grid(c):
    return VoxelGrid(origin=_t(c["origin"]), stats=_t(c["stats"]), fin=_t(c["fin"]))


def _graph(c):
    return pg.GraphData(*(_t(a) for a in c["graph"]))


def parallel_cases(mesh, cases):
    """Every sharded op of the port on this rank, with the collectives each
    executed: NDT, Scan Context and ISC retrieval, ICP, the pose-graph
    gradient demo and solve, the descriptor from partials, and
    `slam_superstep`."""
    out = {}
    c = cases["ndt"]
    gspec, nspec = vm.GridSpec(*c["gspec"]), ndt.NdtSpec(*c["nspec"])
    grid = _grid(c)
    res, k = _count(lambda: ndt.align(grid, _t(c["src"]), _t(c["mask"]), _t(c["init"]),
                                      gspec, nspec, mesh=mesh))
    out["ndt"] = {**_np(res)._asdict(), "collectives": k}
    if "regather_dist" in c:
        # the same align with the neighbourhood frozen within regather_dist
        res = ndt.align(grid, _t(c["src"]), _t(c["mask"]), _t(c["init"]), gspec,
                        nspec._replace(regather_dist=c["regather_dist"]), mesh=mesh)
        out["ndt_regather"] = _np(res)._asdict()

    c = cases["sc"]
    spec = sc.ScSpec(*c["spec"])
    out["sc"] = [_np(sc.detect_loop_on_device(_t(q), _t(c["db"]), int(count), spec,
                                              mesh=mesh))._asdict()
                 for q, count in zip(c["queries"], c["counts"])]
    part = sc.descriptor_partial(_t(c["xyz"])[mesh.shard(len(c["xyz"]), "points")],
                                 _t(c["xyz_mask"])[mesh.shard(len(c["xyz"]), "points")],
                                 spec)
    out["desc"] = _np(sc.finalize_descriptor(collectives.shard_allmax(part, mesh)))

    c = cases["isc"]
    spec = isc.IscSpec(*c["spec"])
    out["isc"] = [_np(isc.detect_loop_on_device(_t(q), _t(c["db"]), int(count),
                                                _t(c["positions"]), _t(c["travel"]), spec,
                                                mesh=mesh))._asdict()
                  for q, count in zip(c["queries"], c["counts"])]

    c = cases["icp"]
    res, k = _count(lambda: icp.align(*(_t(a) for a in c["args"]), icp.IcpSpec(*c["spec"]),
                                      mesh=mesh))
    out["icp"] = {**_np(res)._asdict(), "collectives": k}

    c = cases["pgo"]
    spec = pg.GraphSpec(*c["spec"])
    out["pgo_demo"] = _np(sharded.sharded_pgo_hvp_demo(mesh, _t(c["noisy"]), _graph(c),
                                                       spec))
    opt, k = _count(lambda: pg.solve(_t(c["poses"]), _graph(c), spec, mesh=mesh))
    out["pgo"] = {"poses": _np(opt), "collectives": k}

    c = cases["superstep"]
    n, p = cases["ndt"], cases["pgo"]
    pose, iters, desc, cand, opt = sharded.slam_superstep(
        mesh, _grid(n), _t(n["src"]), _t(n["mask"]), _t(n["init"]),
        vm.GridSpec(*n["gspec"]), ndt.NdtSpec(*n["nspec"]), _t(c["db"]), int(c["count"]),
        sc.ScSpec(*c["spec"]), _t(p["poses"]), _graph(p), pg.GraphSpec(*p["spec"]))
    out["superstep"] = {"pose": _np(pose), "iterations": int(iters), "desc": _np(desc),
                        "cand": _np(cand), "opt": _np(opt)}
    return out
