"""The port's collectives, topology and launcher rule against the JAX
package, on a CPU gloo world of four ranks.

The JAX eager collectives take the stacked per-rank view ``[nranks,
...]`` on one controller; the port's ranks are processes, each with its
own tensor. One world serves the file (``_torch_dist_workers``): rank
``r``'s result must equal row ``r`` of the JAX op's result on the
stacked inputs (the list of ``tests/test_collective.py``), run here on a
4-device JAX mesh. Exact equality for moves; 1e-5 relative for sums.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.spawn_mod import spawn

N = 4
CASES = ("collectives", "topology", "data_parallel", "watchdog")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("collective_world")
    spawn("_torch_dist_workers:run", args=(str(out), CASES), nprocs=N)
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _case(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert not (isinstance(r, str) and r.startswith("FAILED")), r
    return res


@pytest.fixture(scope="module")
def jax_group():
    import paddle_tpu.distributed as jdist
    return jdist.new_group(ranks=list(range(N)))


def _per_rank():
    return np.random.RandomState(0).randn(N, 4, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["sum", "max", "min", "avg", "prod"])
def test_all_reduce_ops(world, jax_group, name):
    import paddle_tpu.distributed as jdist
    x = _per_rank()
    if name == "prod":
        x = np.abs(x) + 0.5
    op = getattr(jdist.ReduceOp, {"avg": "AVG", "prod": "PROD"}.get(
        name, name.upper()))
    want = np.asarray(jdist.all_reduce(jnp.asarray(x), op=op,
                                       group=jax_group))
    for r, res in enumerate(_case(world, "collectives")):
        np.testing.assert_allclose(res["all_reduce_" + name], want[r],
                                   rtol=1e-5)
        if name != "prod":
            assert res["in_place_" + name] is True


def test_all_gather_both_forms(world, jax_group):
    import paddle_tpu.distributed as jdist
    x = _per_rank()
    want = np.asarray(jdist.all_gather(jnp.asarray(x), group=jax_group))
    for r, res in enumerate(_case(world, "collectives")):
        np.testing.assert_array_equal(res["all_gather"], want[r])
        np.testing.assert_array_equal(np.stack(res["all_gather_list"]),
                                      want[r])


def test_broadcast_reduce_scatter(world, jax_group):
    import paddle_tpu.distributed as jdist
    x = _per_rank()
    bc = np.asarray(jdist.broadcast(jnp.asarray(x), src=3, group=jax_group))
    red = np.asarray(jdist.reduce(jnp.asarray(x), dst=2, group=jax_group))
    for r, res in enumerate(_case(world, "collectives")):
        np.testing.assert_array_equal(res["broadcast"], bc[r])
        np.testing.assert_allclose(res["reduce"], red[r], rtol=1e-5)
        # the JAX scatter of the stacked view leaves row r on rank r
        np.testing.assert_array_equal(res["scatter_list"], x[r])


def test_alltoall_and_ppermute_shift(world, jax_group):
    import paddle_tpu.distributed as jdist
    blocks = np.random.RandomState(1).randn(N, N, 2).astype(np.float32)
    a2a = np.asarray(jdist.alltoall(jnp.asarray(blocks), group=jax_group))
    x = _per_rank()
    up = np.asarray(jdist.ppermute_shift(jnp.asarray(x), group=jax_group,
                                         shift=1))
    down = np.asarray(jdist.ppermute_shift(jnp.asarray(x), group=jax_group,
                                           shift=-1))
    for r, res in enumerate(_case(world, "collectives")):
        np.testing.assert_array_equal(res["alltoall"], a2a[r])
        np.testing.assert_array_equal(np.stack(res["alltoall_list"]),
                                      a2a[r])
        np.testing.assert_array_equal(res["shift+1"], up[r])
        np.testing.assert_array_equal(res["shift-1"], down[r])


def test_new_group_subset_send_recv_and_objects(world):
    x = _per_rank()
    res = _case(world, "collectives")
    for r in (0, 2):
        np.testing.assert_allclose(res[r]["subset"], x[0] + x[2], rtol=1e-6)
    assert all(rr["subset_nranks"] == 2 for rr in res)
    for r in (1, 3):
        np.testing.assert_array_equal(res[r]["recv"],
                                      np.array([1.0, 2.0, 3.0]) * r)
    for rr in res:
        assert rr["objects"] == [{"rank": i} for i in range(N)]
        np.testing.assert_allclose(rr["arrays"][0], x.sum(0), rtol=1e-5)
        np.testing.assert_allclose(rr["arrays"][1], 2 * x.sum(0), rtol=1e-5)
        assert rr["wait_is_identity"] is True
        assert rr["world"] == (N, N)


def test_hybrid_groups_and_rank_coordinates(world):
    """fleet.init on dp = 2 x mp = 2: each rank's coordinate, groups and
    mode are those of the JAX ``CommunicateTopology``."""
    from paddle_tpu.distributed.fleet import CommunicateTopology as JaxTopo
    topo = JaxTopo(("dp", "pp", "sharding", "sp", "mp"), (2, 1, 1, 1, 2))
    for r, res in enumerate(_case(world, "topology")):
        assert tuple(res["coord"]) == topo.get_coord(r)
        assert res["dp_rank"] == topo.get_coord(r)[0]
        assert res["mp_rank"] == topo.get_coord(r)[4]
        assert [res["dp_group"]] == [g for g in topo.get_comm_list("dp")
                                     if r in g]
        assert [res["mp_group"]] == [g for g in topo.get_comm_list("mp")
                                     if r in g]
        assert res["mode"] == "model"
        assert res["mp_sum"] == sum(res["mp_group"])


@pytest.mark.parametrize("dims", [(2, 2, 1, 1, 2), (1, 1, 2, 1, 4),
                                  (4, 1, 1, 2, 1), (3, 1, 1, 1, 2)])
def test_topology_matches_jax(dims):
    from paddle_tpu.distributed.fleet import CommunicateTopology as JaxTopo
    from paddle_tpu_torch.distributed.fleet import CommunicateTopology
    names = ("dp", "pp", "sharding", "sp", "mp")
    ours, ref = CommunicateTopology(names, dims), JaxTopo(names, dims)
    assert ours.world_size() == ref.world_size()
    for r in range(ref.world_size()):
        assert ours.get_coord(r) == ref.get_coord(r)
        assert ours.get_rank(**dict(zip(names, ref.get_coord(r)))) == r
    for ax in names:
        assert ours.get_comm_list(ax) == ref.get_comm_list(ax)
        assert ours.get_axis_list(ax, 0) == ref.get_axis_list(ax, 0)


def test_validate_topology_and_unported_layouts():
    from paddle_tpu_torch.distributed.fleet import (HybridCommunicateGroup,
                                                    MeshTopologyError,
                                                    validate_topology)
    assert validate_topology({"dp": 2, "mp": 2}, 8) == 4
    with pytest.raises(MeshTopologyError, match="needs 8 ranks"):
        validate_topology({"dp": 2, "mp": 4}, 4)
    with pytest.raises(MeshTopologyError, match="does not factor"):
        validate_topology({"dp": 3}, 4)
    with pytest.raises(NotImplementedError, match="part 2"):
        HybridCommunicateGroup(pp_degree=2, devices=[0, 1])


def test_data_parallel_averages_and_no_sync_defers(world):
    for r, res in enumerate(_case(world, "data_parallel")):
        # d(sum(W x + b))/dW = rows of x summed: 2 * (r + 1) a column
        np.testing.assert_allclose(res["local"],
                                   np.full((2, 3), 2.0 * (r + 1)))
        np.testing.assert_allclose(res["synced"], np.full((2, 3), 5.0))


def test_watchdog_converts_a_hang_into_collective_timeout(world):
    for res in _case(world, "watchdog"):
        assert res["error"][:2] == ("CollectiveTimeoutError", "all_reduce")
        assert res["error"][3] == 0.5
        assert 0.5 <= res["seconds"] < 10.0
        assert res["after"] == N


def test_nccl_needs_a_card_per_rank(monkeypatch):
    """More ranks on a node than cards: the default (NCCL on a card)
    and an explicit "nccl" raise and name the rule; "gloo" is taken."""
    from paddle_tpu_torch.distributed import parallel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("WORLD_SIZE", "4")
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            parallel._resolve_backend(backend)
    assert parallel._resolve_backend("gloo") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert parallel._resolve_backend(None) == "nccl"


def test_single_process_ops_are_identities():
    import paddle_tpu_torch.distributed as dist
    t = torch.ones(3)
    assert dist.all_reduce(t) is t
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    np.testing.assert_array_equal(dist.all_gather(t).numpy(), np.ones((1, 3)))
    with pytest.raises(AttributeError):
        dist.definitely_not_a_thing
