"""The intra-broker disk path on the 8-broker cluster of
__graft_entry__.py:22 with 4 disks a broker (JBOD) and more partitions a
topic: ``INTRA_BROKER_GOAL_ORDER`` healthy and with the first disk of
broker 0 dead, and the mixed stack IntraBrokerDiskCapacityGoal,
DiskCapacityGoal, DiskUsageDistributionGoal (a ``goals=`` request with
``rebalance_disk=true``: the intra goal's disk veto judges the inter-broker
goals' moves and swaps), each on the grouped and on the sequential
per-goal path, against the JAX package's: per goal the same packed slots
and the same placement, replicas and disks.  The intra stack moves no
replica across brokers, leaves none on the dead disk and passes
``verify_run``; the mixed stack passes it over its goals that held (the
inter-broker goals may leave the intra goal violated at the end, in the
JAX package as in the port)."""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.analyzer.verifier import verify_run
from tests.torch_port_helpers import (MIXED_DISK_GOALS, SPEC_ENTRY, check_intra, jbod_model,
                                      on_dead_disks)

SPEC = dict(SPEC_ENTRY, num_topics=5, mean_partitions_per_topic=16.0, seed=3)


@pytest.mark.parametrize("path", ["grouped", "per-goal"])
@pytest.mark.parametrize("dead", [(), (0,)], ids=["healthy", "dead-disk"])
def test_intra_disk_8_brokers(dead, path):
    jm = jbod_model(SPEC, dead=dead)
    assert (on_dead_disks(jm) > 0) == bool(dead)
    tm, trun = check_intra(jm, path)
    np.testing.assert_array_equal(trun.model.replica_broker.numpy(), tm.replica_broker.numpy())
    assert on_dead_disks(trun.model) == 0


@pytest.mark.parametrize("path", ["grouped", "per-goal"])
def test_mixed_disk_stack_8_brokers(path):
    tm, trun = check_intra(jbod_model(SPEC), path, MIXED_DISK_GOALS, verify=False)
    assert not (trun.model.replica_broker == tm.replica_broker).all()
    final = trun.model
    arrays = BrokerArrays.from_model(final)
    held = [(name, g) for name, g in zip(MIXED_DISK_GOALS, trun.goal_results)
            if bool(tk.goal_satisfied(GOAL_SPECS[name], final, arrays,
                                      BalancingConstraint.default()))
            or not g.is_hard]
    verify_run(tm, dataclasses.replace(trun, goal_results=[g for _, g in held]),
               [name for name, _ in held], proposals=tprops.diff(tm, final))
