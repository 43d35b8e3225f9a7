"""What the ranks of tests/test_torch_mesh.py run: each function takes the
rank's ``SearchMesh`` first and returns numpy results to the parent.  This
module imports the port only (no JAX), so that a spawned rank starts
fast."""

from __future__ import annotations

import os

import torch

from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays, OptimizationOptions
from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.convert import model_from_numpy
from cruise_control_tpu_torch.model.tensor_model import TENSOR_FIELDS
from cruise_control_tpu_torch.parallel import collectives
from cruise_control_tpu_torch.parallel import mesh as pmesh

PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")
# tests/test_parallel.py's widths: multiples of 8, so the lane rounding of
# compacted widths is the same on 2 ranks as on 8 devices.
NS, ND = 32, 8
FRONTIER_KW = dict(num_sources=8, num_dests=8, max_steps=64, chunk_steps=8, min_chunk=1)
# The four paths of ``optimize``, as keyword arguments.
PATHS = {"unfused": {}, "grouped": {"fused": True},
         "per-goal": {"fused": True, "fuse_group_size": 1},
         "pipelined": {"fused": True, "pipeline": True}}


def placement(model):
    return {f: getattr(model, f).cpu().numpy() for f in PLACEMENT}


def goal_rows(run):
    return [(g.name, g.steps, g.actions_applied, g.satisfied_after, g.capped)
            for g in run.goal_results]


def solve(model, goals, mesh=None, **kw):
    """``optimize`` of ``goals`` on the CPU with tests/test_parallel.py's
    widths: (per-goal rows, placement)."""
    run = topt.optimize(model, goals, num_sources=NS, num_dests=ND,
                        raise_on_hard_failure=False, device="cpu", mesh=mesh, **kw)
    return goal_rows(run), placement(run.model)


def aggregates(model, mesh=None):
    """The optimizer's per-broker aggregates and disk loads of ``model``
    (under ``mesh``: split over the ranks' rows and combined by K15)."""
    a = BrokerArrays.from_model(model, with_disk_load=True, mesh=mesh)
    return {"broker_load": a.load.numpy(), "potential_nw_out": a.potential_nw_out.numpy(),
            "leader_bytes_in": a.leader_bytes_in.numpy(), "disk_load": a.disk_load.numpy(),
            "replica_count": a.replica_count.numpy(), "leader_count": a.leader_count.numpy()}


def model_queries(model):
    """The model's own load queries, which issue no collective."""
    return {"broker_load": model.broker_load().numpy(),
            "potential_nw_out": model.potential_leadership_load().numpy(),
            "leader_bytes_in": model.broker_leader_bytes_in().numpy(),
            "disk_load": model.disk_load().numpy()}


def two_rank_cases(mesh, fixture, skewed, stack):
    """Every case of the 2-rank gloo mesh, on the JAX fixture model
    (``fixture``: its numpy fields and static ints), the skewed 32-broker
    model and the goal ``stack``."""
    model = model_from_numpy(*fixture, device="cpu")
    con = BalancingConstraint.default()
    options = OptimizationOptions.none(model)
    rd = GOAL_SPECS["ReplicaDistributionGoal"]
    out = {"rank": mesh.rank, "size": mesh.size}

    step = pmesh.make_sharded_step(rd, (), con, NS, ND, mesh)
    stepped, n, _ = step(model, options)
    out["step"] = (int(n), placement(stepped))

    final, steps, actions = pmesh.distributed_optimize_goal(model, rd, (), con, options,
                                                            mesh)
    out["goal"] = (steps, actions, placement(final))

    sharded = pmesh.shard_model_replica_axis(model, mesh)
    out["aggregates"] = aggregates(sharded, mesh)
    coll0 = collectives.COUNTERS["collectives"]
    out["queries"] = (model_queries(sharded), model_queries(model),
                      collectives.COUNTERS["collectives"] - coll0)
    run = topt.optimize(sharded, ["ReplicaDistributionGoal"], num_sources=NS,
                        num_dests=ND, device="cpu", mesh=mesh)
    out["returned_mesh"] = run.model.replica_mesh
    # The rows the rank's reductions cover, of every replica-axis field.
    lo, hi = collectives.lane_range(sharded.num_replicas_padded, mesh)
    rows = {f for f in TENSOR_FIELDS if f.startswith("replica_")
            and getattr(sharded, f).shape[0] == sharded.num_replicas_padded}
    out["round_trip"] = {"rows": (lo, hi), "replica_fields": sorted(rows), "fields": {
        f: (getattr(sharded, f)[lo:hi] if f in rows else getattr(sharded, f)).numpy()
        for f in TENSOR_FIELDS}}

    topt._FRONTIER_DENSE_MIN = 8
    skew = model_from_numpy(*skewed, device="cpu")
    before = dict(topt.FETCH_COUNTERS)
    fm, info = pmesh.distributed_frontier_fixpoint(
        skew, rd, (), con, OptimizationOptions.none(skew), mesh, **FRONTIER_KW)
    fetches = topt.FETCH_COUNTERS["device_fetches"] - before["device_fetches"]
    out["frontier"] = ({k: info[k] for k in ("steps", "actions", "satisfied_after",
                                             "buckets", "chunks_speculative", "fetches",
                                             "mesh")},
                       len(info["chunks"]), fetches, placement(fm))
    out["frontier_stack"] = solve(pmesh.shard_model_replica_axis(skew, mesh), stack,
                                  mesh, fused=True, pipeline=True)
    topt._FRONTIER_DENSE_MIN = 64

    out["lanes"] = {}
    for k in (7, 1, 0):
        lo, hi = collectives.lane_range(k, mesh)
        local = torch.arange(lo, hi, dtype=torch.int32)[None]
        out["lanes"][k] = collectives.all_gather_lanes(mesh, local, k).numpy()

    out["flight"] = flight_timelines(model, stack, mesh)

    coll0 = collectives.COUNTERS["collectives"]
    out["stack"] = {name: solve(sharded, stack, mesh, **kw) for name, kw in PATHS.items()}
    out["collectives"] = collectives.COUNTERS["collectives"] - coll0
    out["sensor"] = sum(v for k, v in SENSORS.snapshot().items()
                        if k.startswith("GoalOptimizer.mesh-collective-ops"))
    return out


def flight_timelines(model, goals, mesh=None):
    """Each goal's flight-recorder steps on the per-goal path
    (``CRUISE_FLIGHT_RECORDER=1``): the rows ``flight_row`` wrote from the
    step's score and eligibility."""
    os.environ["CRUISE_FLIGHT_RECORDER"] = "1"
    try:
        run = topt.optimize(model, goals, num_sources=NS, num_dests=ND,
                            raise_on_hard_failure=False, device="cpu", mesh=mesh,
                            fused=True, fuse_group_size=1)
    finally:
        del os.environ["CRUISE_FLIGHT_RECORDER"]
    return [None if g.flight is None else g.flight["steps"] for g in run.goal_results]


def one_rank_cases(mesh, fixture, skewed, stack):
    """A one-rank mesh: the replica-sharded model's aggregates and the
    grouped solve, to be held bit for bit against the unsharded run; and,
    in the same process (beside the parent's JAX references), the port's
    one-device references of the 2-rank cases, with no mesh."""
    model = model_from_numpy(*fixture, device="cpu")
    sharded = pmesh.shard_model_replica_axis(model, mesh)
    out = {"aggregates": aggregates(sharded, mesh),
           "stack": solve(sharded, stack, mesh, fused=True),
           "port_aggregates": aggregates(model),
           "port_stack": {name: solve(model, stack, **kw) for name, kw in PATHS.items()},
           "port_flight": flight_timelines(model, stack)}
    topt._FRONTIER_DENSE_MIN = 8
    out["port_frontier_stack"] = solve(model_from_numpy(*skewed, device="cpu"), stack,
                                       fused=True, pipeline=True)
    return out


def sharded_stack(mesh, fixture, stack):
    """The unfused ``stack`` on the replica-sharded fixture model."""
    model = model_from_numpy(*fixture, device="cpu")
    return solve(pmesh.shard_model_replica_axis(model, mesh), stack, mesh)
