"""The port's packed reductions (`xchu_slam_tpu_torch/utils/collectives.py`)
on a group of 4 gloo ranks, the counterparts of tests/test_collectives.py:
one all-gather a call, bit-identical to the per-leaf form and to a numpy
float32 sum in rank order, and against the JAX package's `shard_allsum` on a
4-device mesh of the test process's virtual CPU devices. The group is formed
once (the module-scoped fixture); the launcher's refusals and its bounded
waits are checked on groups of their own."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import mesh_cases
from xchu_slam_tpu.utils import collectives as jcollectives
from xchu_slam_tpu_torch.parallel import distributed

D = 4
HERE = os.path.dirname(os.path.abspath(__file__))
BIG = (1 << 20) + 3          # an integer leaf; D·BIG < 2^24, exact in float32


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"L": np.float32(rng.normal()),
            "g": rng.normal(size=(D, 6)).astype(np.float32),
            "H": rng.normal(size=(D, 6, 6)).astype(np.float32),
            "n": rng.integers(0, 1000, size=(D,)).astype(np.int32)}


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's results, from one group of D gloo ranks."""
    i = inputs
    return distributed.launch(D, "mesh_cases:collectives_cases",
                              (i["L"], i["g"], i["H"], i["n"], np.int32(BIG)),
                              timeout_s=120, path=(HERE,))


def _rank_order_sum(rows):
    acc = rows[0]
    for r in rows[1:]:
        acc = (acc + r).astype(np.float32)
    return acc


def test_every_rank_holds_the_same_bits(ranks):
    for r in range(1, D):
        for key in ("packed", "per_leaf", "exact", "bcast", "amax", "gathered"):
            for a, b in zip(ranks[r][key], ranks[0][key]):
                assert np.array_equal(a, b), (r, key)


def test_shard_allsum_bit_identical_to_per_leaf_and_rank_order(ranks, inputs):
    """The packed call and one call a leaf give the same bits, and so does a
    numpy float32 sum of the same per-rank values in rank order."""
    packed, per_leaf = ranks[0]["packed"], ranks[0]["per_leaf"]
    for a, b in zip(packed[:3], per_leaf):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    L, g, H = inputs["L"], inputs["g"], inputs["H"]
    assert np.array_equal(packed[0], _rank_order_sum([L] * D))
    assert np.array_equal(packed[1], _rank_order_sum(list(g)))
    assert np.array_equal(packed[2], _rank_order_sum(list(H)))
    assert packed[3].dtype == np.int32 and int(packed[3]) == int(inputs["n"].sum())


def test_shard_allsum_int_leaf_exact(ranks):
    """An integer leaf rides the packed float32 vector and comes back exact
    below 2^24, in its own dtype."""
    count, ones = ranks[0]["exact"]
    assert count.dtype == np.int32 and int(count) == D * BIG
    assert np.array_equal(ones, np.full(2, D, np.float32))


def test_shard_bcast0_takes_rank0(ranks, inputs):
    for r in range(D):
        g0, H0 = ranks[r]["bcast"]
        assert np.array_equal(g0, inputs["g"][0]) and np.array_equal(H0, inputs["H"][0])


def test_shard_allmax_and_allgather(ranks, inputs):
    assert np.array_equal(ranks[0]["amax"], inputs["H"].max(0))
    g, n = ranks[0]["gathered"]
    assert np.array_equal(g, inputs["g"]) and np.array_equal(n, inputs["n"])


def test_packed_reduction_is_one_collective(ranks):
    """The packed form is one all-gather however many leaves it carries; the
    per-leaf form is one a leaf."""
    assert ranks[0]["c_packed"] == 1
    assert ranks[0]["c_per_leaf"] == 3


def test_against_the_jax_package(ranks, inputs):
    """The JAX package's `shard_allsum` on a 4-device mesh, the same per-rank
    leaves: within rtol 1e-6 (XLA's sum over the gathered axis need not add
    in rank order)."""
    mesh = JMesh(np.array(jax.devices()[:D]), ("data",))

    def body(L, g, h, n):
        return jcollectives.shard_allsum((L, g[0], h[0], n[0]), "data")

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data")),
                          out_specs=P(), check_vma=False))
    want = f(jnp.asarray(inputs["L"]), jnp.asarray(inputs["g"]), jnp.asarray(inputs["H"]),
             jnp.asarray(inputs["n"]))
    for got, w in zip(ranks[0]["packed"], want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- refusals -- #

def test_a_failing_rank_makes_launch_raise_naming_it():
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 \(mesh_cases:failing_rank, gloo\) "
                                           r"exited with code 3"):
        distributed.launch(2, "mesh_cases:failing_rank", timeout_s=60, path=(HERE,))


def test_a_hanging_rank_makes_launch_raise_naming_it():
    # the bound leaves rank 0 room to start and return on a loaded host
    with pytest.raises(RuntimeError, match=r"ranks \[1\] of 2 .* had not returned after 30"):
        distributed.launch(2, "mesh_cases:hanging_rank", timeout_s=30, path=(HERE,))


def test_nccl_with_more_ranks_than_cards_is_refused_by_name(tmp_path):
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"NCCL needs one card a rank: {cards + 1} ranks, "
                                         f"{cards} visible cards"):
        distributed.initialize("nccl", "file://" + str(tmp_path / "store"), cards + 1, 0)
    with pytest.raises(ValueError, match="NCCL needs one card a rank"):
        distributed.launch(cards + 1, "mesh_cases:failing_rank", backend="nccl",
                           device="cuda", path=(HERE,))


def test_initialize_without_a_group_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is None
    assert distributed.topology()["process_count"] == 1
