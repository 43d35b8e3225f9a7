"""The sharded search of the PyTorch port (``cruise_control_tpu_torch/parallel``)
on two gloo ranks on the CPU, against the JAX package's sharded search on its
8-device virtual CPU mesh (tests/test_parallel.py, case for case) and against
the port's own one-device runs.

One module fixture spawns the two ranks once (and a one-rank mesh beside
them, which also computes the port's one-device references), runs every
sharded case in them and returns numpy results; the parent meanwhile
computes the JAX package's references.  The widths are multiples of 8, so the lane rounding of the
compacted widths is the same on 2 ranks as on 8 devices.

Tolerances: integer outputs and placements exactly; the replica-axis
aggregates within rtol 1e-5 of the JAX package's sharded ``broker_load``
(its own tolerance for the same split, tests/test_parallel.py:71: each
rank's rows, then the ranks, is another float order); K15's plain twin
exactly against a numpy sum in rank order.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.parallel import mesh as jmesh
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from cruise_control_tpu_torch.convert import model_to_numpy
from cruise_control_tpu_torch.model.tensor_model import TENSOR_FIELDS
from cruise_control_tpu_torch.ops import segment
from cruise_control_tpu_torch.parallel import mesh as pmesh
from tests.test_parallel import FULL_STACK, _skewed_model
from tests.torch_mesh_ranks import (FRONTIER_KW, ND, NS, PATHS, PLACEMENT, one_rank_cases,
                                    two_rank_cases)
from tests.torch_port_helpers import clear_cruise_env, to_torch

RANK_TIMEOUT_S = 600


def _jax_fixture():
    """tests/test_parallel.py's ``model`` fixture."""
    spec = JaxSpec(num_brokers=8, num_racks=4, num_topics=4, mean_partitions_per_topic=12.0,
                   replication_factor=2, distribution="exponential", seed=13)
    return jax_generate(spec, pad_replicas_to_multiple=8)


def _jax_refs(jm, jskew):
    """The JAX package's references: the one-device and sharded step, the
    sharded goal fixpoint, the sharded aggregates, the one-device frontier
    driver on the skewed model."""
    mesh = jmesh.make_search_mesh()
    con = JaxBC.default()
    options = JaxOptions.none(jm)
    rd = JAX_SPECS["ReplicaDistributionGoal"]
    one, one_n, _ = jopt._get_step_fn(rd, (), con, NS, ND)(jm, options)
    sh, sh_n, _ = jmesh.make_sharded_step(rd, (), con, NS, ND, mesh)(jm, options)
    final, steps, actions = jmesh.distributed_optimize_goal(jm, rd, (), con, options, mesh)
    sharded = jmesh.shard_model_replica_axis(jm, mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
        fm, finfo = jopt.frontier_fixpoint(jskew, JaxOptions.none(jskew), rd, (), con,
                                           **FRONTIER_KW)
    return {
        "step": (int(one_n), np.asarray(one.replica_broker), int(sh_n),
                 np.asarray(sh.replica_broker)),
        "goal": (steps, actions, np.asarray(final.replica_broker)),
        "aggregates": {"broker_load": np.asarray(sharded.broker_load()),
                       "potential_nw_out": np.asarray(sharded.potential_leadership_load()),
                       "leader_bytes_in": np.asarray(sharded.broker_leader_bytes_in()),
                       "disk_load": np.asarray(sharded.disk_load()),
                       "replica_count": np.asarray(sharded.broker_replica_counts()),
                       "leader_count": np.asarray(sharded.broker_leader_counts())},
        "sharded_model": sharded,
        "frontier": (finfo, {f: np.asarray(getattr(fm, f)) for f in PLACEMENT}),
    }


@pytest.fixture(scope="module")
def mesh_run():
    """The ranks' results (2-rank mesh, one-rank mesh) beside the
    references."""
    jm, jskew = _jax_fixture(), _skewed_model()
    fixture, skewed = model_to_numpy(to_torch(jm)), model_to_numpy(to_torch(jskew))
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)  # the spawned ranks inherit this environment
        two = pmesh.Ranks(two_rank_cases, 2, "cpu", "gloo", (fixture, skewed, FULL_STACK))
        one = pmesh.Ranks(one_rank_cases, 1, "cpu", "gloo", (fixture, skewed, FULL_STACK))
        try:
            refs = _jax_refs(jm, jskew)
        finally:
            ranks = two.join(RANK_TIMEOUT_S)
            single = one.join(RANK_TIMEOUT_S)[0]
    refs.update({k: v for k, v in single.items() if k.startswith("port_")})
    return {"jm": jm, "tm": to_torch(jm), "ranks": ranks, "one": single, "refs": refs}


def _both(mesh_run, key):
    """The two ranks' results under ``key``, checked identical."""
    r0, r1 = (r[key] for r in mesh_run["ranks"])
    _assert_same(r0, r1, key)
    return r0


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _proposal_set(tm, placement):
    final = tm.replace(**{f: torch.from_numpy(placement[f]) for f in PLACEMENT})
    return {(p.partition, tuple(r.broker for r in p.new_replicas), p.new_leader.broker)
            for p in tprops.diff(tm, final)}


def test_ranks_form_a_two_rank_mesh(mesh_run):
    assert [(r["rank"], r["size"]) for r in mesh_run["ranks"]] == [(0, 2), (1, 2)]


def test_sharded_step_matches_jax(mesh_run):
    """tests/test_parallel.py:32-47: the sharded step keeps as many
    candidates and places as the JAX one-device and sharded steps."""
    n, pl = _both(mesh_run, "step")
    one_n, one_rb, sh_n, sh_rb = mesh_run["refs"]["step"]
    assert n == one_n == sh_n
    np.testing.assert_array_equal(pl["replica_broker"], one_rb)
    np.testing.assert_array_equal(pl["replica_broker"], sh_rb)


def test_distributed_goal_matches_jax_sharded(mesh_run):
    """tests/test_parallel.py:50-61: steps and actions of the JAX sharded
    fixpoint, and its placement."""
    steps, actions, pl = _both(mesh_run, "goal")
    jsteps, jactions, jrb = mesh_run["refs"]["goal"]
    assert actions > 0
    assert (steps, actions) == (jsteps, jactions)
    np.testing.assert_array_equal(pl["replica_broker"], jrb)


def test_replica_axis_aggregates_match_jax_sharded(mesh_run):
    """tests/test_parallel.py:64-71: K1 over each rank's rows and K15
    across the ranks give the JAX sharded aggregates within rtol 1e-5, the
    counts exactly."""
    got = _both(mesh_run, "aggregates")
    want = mesh_run["refs"]["aggregates"]
    for name in ("broker_load", "potential_nw_out", "leader_bytes_in", "disk_load"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)
    for name in ("replica_count", "leader_count"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_model_queries_stay_local(mesh_run):
    """A replica-sharded model's own load queries reduce over all rows on
    the rank, with no collective (a rank may call them alone), equal to the
    unsharded model's bit for bit; a solve under the mesh returns an
    unsharded model."""
    sharded_q, plain_q, n_coll = _both(mesh_run, "queries")
    assert n_coll == 0
    _assert_same(sharded_q, plain_q, "queries")
    assert _both(mesh_run, "returned_mesh") is None


def test_sharded_model_without_its_mesh_is_refused(mesh_run):
    """``optimize`` of a model placed with ``shard_model_replica_axis``
    but no mesh raises before any step."""
    tm = mesh_run["tm"]
    mesh = pmesh.SearchMesh(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    sharded = pmesh.shard_model_replica_axis(tm, mesh)
    with pytest.raises(ValueError, match="pass that mesh"):
        topt.optimize(sharded, ["ReplicaDistributionGoal"], device="cpu")


def test_mixed_placement_round_trip(mesh_run):
    """tests/test_parallel.py:131-153: the replica-axis fields are split
    over the ranks' rows, everything else whole, and every field round-trips
    bit for bit; a JAX model placed with its ``shard_model_replica_axis``
    converts to the same port model."""
    tm = mesh_run["tm"]
    r = tm.num_replicas_padded
    r0, r1 = (rank["round_trip"] for rank in mesh_run["ranks"])
    assert (r0["rows"], r1["rows"]) == ((0, r // 2), (r // 2, r))
    assert r0["replica_fields"] == r1["replica_fields"]
    sharded_fields = set(r0["replica_fields"])
    assert sharded_fields and sharded_fields != set(TENSOR_FIELDS)
    for name in TENSOR_FIELDS:
        x0 = getattr(tm, name).numpy()
        if name in sharded_fields:
            assert x0.shape[0] == r, name
            got = np.concatenate([r0["fields"][name], r1["fields"][name]])
        else:
            _assert_same(r0["fields"][name], r1["fields"][name], name)
            got = r0["fields"][name]
        np.testing.assert_array_equal(got, x0, err_msg=name)
    converted = to_torch(mesh_run["refs"]["sharded_model"])
    for name in TENSOR_FIELDS:
        assert torch.equal(getattr(converted, name), getattr(tm, name)), name


def test_non_divisible_axis_is_refused(mesh_run):
    """tests/test_parallel.py:114-128: a padded replica axis that does not
    divide the mesh is refused up front by the placement helper and the
    sharded chunk driver (before any collective)."""
    tm = mesh_run["tm"]
    r = tm.num_replicas_padded
    bad_n = next(k for k in (3, 5, 7) if r % k)
    mesh = pmesh.SearchMesh(rank=0, world=bad_n, device=torch.device("cpu"),
                            backend="gloo")
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_model_replica_axis(tm, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.distributed_frontier_fixpoint(
            tm, GOAL_SPECS["ReplicaDistributionGoal"], (), BalancingConstraint.default(),
            OptimizationOptions.none(tm), mesh)


def test_frontier_driver_matches_jax_single_device(mesh_run):
    """tests/test_parallel.py:215-245: the sharded chunk driver on the
    skewed model (floor 8) matches the JAX one-device driver in steps,
    actions, buckets and placement, compacts, speculates, and keeps one
    host fetch per boundary."""
    info, n_chunks, fetches, pl = _both(mesh_run, "frontier")
    jinfo, jpl = mesh_run["refs"]["frontier"]
    assert (info["steps"], info["actions"], info["satisfied_after"]) == \
        (jinfo["steps"], jinfo["actions"], jinfo["satisfied_after"])
    for f in ("replica_broker", "replica_is_leader"):
        np.testing.assert_array_equal(pl[f], jpl[f], err_msg=f)
    assert info["buckets"], "the sharded driver never compacted"
    assert info["buckets"] == jinfo["buckets"]
    assert info["chunks_speculative"] >= 1
    assert fetches == info["fetches"] == n_chunks
    assert info["mesh"]["devices"] == 2
    assert info["mesh"]["fetch_bytes"] > 0
    assert info["mesh"]["collectives"] > 0


@pytest.mark.parametrize("path", list(PATHS))
def test_full_stack_sharded_matches_one_device(mesh_run, path):
    """tests/test_parallel.py:84-111 on each path of ``optimize``: the
    15-goal stack on the replica-sharded model over the 2-rank mesh and on
    one device — per goal (steps, actions, satisfied after, capped), the
    placement and the proposal set identical."""
    rows, pl = _both(mesh_run, "stack")[path]
    want_rows, want_pl = mesh_run["refs"]["port_stack"][path]
    assert rows == want_rows
    _assert_same(pl, want_pl, path)
    tm = mesh_run["tm"]
    assert _proposal_set(tm, pl) == _proposal_set(tm, want_pl)


def test_pipelined_stack_compacts_alike(mesh_run):
    """The pipelined path on the skewed 32-broker model with the floor at 8
    (compacted chunks, openers, lane-rounded widths),
    replica-sharded over the 2 ranks, places as one device does."""
    rows, pl = _both(mesh_run, "frontier_stack")
    want_rows, want_pl = mesh_run["refs"]["port_frontier_stack"]
    assert rows == want_rows
    _assert_same(pl, want_pl, "frontier_stack")


def test_flight_recorder_under_the_mesh(mesh_run):
    """The flight recorder keeps working under a mesh: on the replicated
    model (the candidate split alone, exact) every rank writes the
    one-device run's rows, best scores included, from the gathered score
    and eligibility."""
    got = _both(mesh_run, "flight")
    assert any(steps for steps in got)
    _assert_same(got, mesh_run["refs"]["port_flight"], "flight")


def test_one_rank_mesh_is_the_unsharded_run(mesh_run):
    """With one rank K15 is the identity: the replica-sharded aggregates
    and the grouped solve equal the unsharded run bit for bit."""
    one = mesh_run["one"]
    _assert_same(one["aggregates"], mesh_run["refs"]["port_aggregates"], "aggregates")
    _assert_same(one["stack"], mesh_run["refs"]["port_stack"]["grouped"], "stack")


def test_collectives_are_counted(mesh_run):
    """The ranks issue the same collectives, and the stack's count reaches
    ``GoalOptimizer.mesh-collective-ops``."""
    n = _both(mesh_run, "collectives")
    assert n > 0
    assert _both(mesh_run, "sensor") > 0


def test_lanes_gather_in_candidate_order(mesh_run):
    """A K that does not divide the mesh: ``ceil(K/n)`` lanes a rank,
    padded, gathered in rank order and trimmed."""
    for k, got in _both(mesh_run, "lanes").items():
        np.testing.assert_array_equal(got, np.arange(k, dtype=np.int32)[None], err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shard_combine_plain_is_rank_order_sum(n):
    """K15's plain twin (and its wrapper on CPU tensors) is the rank-order
    float32 sum ``((p0 + p1) + p2) + ...`` and the exact integer sum."""
    rng = np.random.default_rng(11 + n)
    f = (rng.standard_normal((n, 50, 6)) * 10.0 ** rng.integers(-3, 6, (n, 50, 6))
         ).astype(np.float32)
    i = rng.integers(-1000, 1000, (n, 50, 2)).astype(np.int32)
    want_f = f[0].copy()
    for r in range(1, n):
        want_f = (want_f + f[r]).astype(np.float32)
    for fn in (segment.shard_combine_plain, segment.shard_combine):
        got_f, got_i = fn(torch.from_numpy(f), torch.from_numpy(i))
        np.testing.assert_array_equal(got_f.numpy(), want_f)
        np.testing.assert_array_equal(got_i.numpy(), i.sum(0, dtype=np.int32))
    got_f, none = segment.shard_combine(torch.from_numpy(f))
    assert none is None
    np.testing.assert_array_equal(got_f.numpy(), want_f)


def test_search_mesh_identity_and_card_default():
    """A mesh is equal and hashable by (rank, world, device, backend);
    ``make_search_mesh`` defaults to the card and raises without one."""
    a = pmesh.SearchMesh(0, 2, torch.device("cpu"), "gloo", group=object())
    b = pmesh.SearchMesh(0, 2, torch.device("cpu"), "gloo", group=object())
    assert a == b and hash(a) == hash(b) and a.size == 2
    assert a != pmesh.SearchMesh(1, 2, torch.device("cpu"), "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_search_mesh()
    assert pmesh.prelower_goal_programs(None, None, (), None, None, a, 1, 1) == []
    assert pmesh.bucket_ladder(200) == tuple(
        b for b in (64, 128) if b >= topt._FRONTIER_DENSE_MIN)
