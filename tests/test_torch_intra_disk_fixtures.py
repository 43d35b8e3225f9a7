"""The JAX package's own intra-broker disk fixtures through the PyTorch port:
tests/test_goals_extended.py:69 (``INTRA_BROKER_GOAL_ORDER`` on 4 brokers
with 4 disks a broker), :90 (IntraBrokerDiskCapacityGoal draining a dead
disk) and tests/test_swaps.py:142 (the hand-built broker with two disks
whose big and small replicas exchange).  Each runs as the fixture runs it
(``optimize`` with its defaults) in both packages on the same model: the
same per-goal packed slots and the same placement, replicas and disks, and
the fixture's own assertions hold on the port's result."""

import jax.numpy as jnp
import numpy as np
import torch

from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import build_model
from cruise_control_tpu_torch.analyzer.goals.specs import INTRA_BROKER_GOAL_ORDER
from tests.torch_port_helpers import PLACEMENT, goal_rows, jopt, to_torch, topt


def _both(jm, goals):
    """(port model, port run) after checking the run against the JAX
    package's on ``jm``."""
    tm = to_torch(jm)
    jrun = jopt.optimize(jm, goals, raise_on_hard_failure=False)
    trun = topt.optimize(tm, goals, raise_on_hard_failure=False, device="cpu")
    assert goal_rows(trun) == goal_rows(jrun)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
    trun.model.sanity_check()
    return tm, trun


def test_intra_broker_disk_goals():
    jm = jax_generate(JaxSpec(num_brokers=4, num_racks=2, num_topics=4,
                              mean_partitions_per_topic=15.0, disks_per_broker=4, seed=12))
    tm, trun = _both(jm, INTRA_BROKER_GOAL_ORDER)
    final = trun.model
    assert torch.equal(final.replica_broker, tm.replica_broker)
    assert int((final.replica_disk != tm.replica_disk).sum()) > 0

    def spread(m):
        pct = m.disk_load().numpy() / m.disk_capacity.numpy()
        return pct.max() - pct.min()
    assert spread(final) < spread(tm)


def test_intra_disk_capacity_heals_dead_disk():
    jm = jax_generate(JaxSpec(num_brokers=3, num_racks=3, num_topics=2,
                              mean_partitions_per_topic=10.0, disks_per_broker=3, seed=4))
    cap = np.asarray(jm.disk_capacity).copy()
    cap[0] = -1.0
    jm = jm.replace(disk_capacity=jnp.asarray(cap))
    tm, trun = _both(jm, ["IntraBrokerDiskCapacityGoal"])
    assert int(tm.replica_offline_now().sum()) > 0
    rd = trun.model.replica_disk.numpy()
    valid = trun.model.replica_valid.numpy()
    assert not (rd[valid] == 0).any(), "dead disk must be drained"


def test_intra_broker_disk_swap():
    load = np.zeros((4, 4), np.float32)
    load[:, 3] = [55.0, 40.0, 15.0, 10.0]
    cap = np.full((1, 4), 1e9, np.float32)
    cap[:, 3] = 200.0
    jm = build_model(
        replica_broker=np.zeros(4, np.int32), replica_partition=np.arange(4, dtype=np.int32),
        replica_topic=np.zeros(4, np.int32), replica_is_leader=np.ones(4, bool),
        replica_load_leader=load, replica_load_follower=load.copy(), broker_capacity=cap,
        broker_rack=np.zeros(1, np.int32), replica_disk=np.array([0, 0, 1, 1], np.int32),
        disk_broker=np.zeros(2, np.int32), disk_capacity=np.array([100.0, 100.0], np.float32))
    tm, trun = _both(jm, ["IntraBrokerDiskUsageDistributionGoal"])
    after = trun.model.disk_load().numpy()[:2]
    before = tm.disk_load().numpy()[:2]
    assert abs(after[0] - after[1]) < np.ptp(before), after
