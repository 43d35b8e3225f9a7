"""The intra-broker disk path (``INTRA_BROKER_GOAL_ORDER``) on the 12-broker
cluster of tests/test_optimizer.py:219 with 4 disks a broker (JBOD),
healthy and with the first disk of broker 1 dead: the port's
``optimize(fused=True)`` on the grouped and on the sequential per-goal path
against the JAX package's, per goal the same packed slots and the same
placement, replicas and disks, no replica moved across brokers, none left
on the dead disk, and ``verify_run`` (tests/torch_port_helpers.py
``check_intra``)."""

import numpy as np
import pytest

from tests.torch_port_helpers import SPEC_12, check_intra, jbod_model, on_dead_disks


@pytest.mark.parametrize("path", ["grouped", "per-goal"])
@pytest.mark.parametrize("dead", [(), (1,)], ids=["healthy", "dead-disk"])
def test_intra_disk_12_brokers(dead, path):
    jm = jbod_model(SPEC_12, dead=dead)
    assert (on_dead_disks(jm) > 0) == bool(dead)
    tm, trun = check_intra(jm, path)
    np.testing.assert_array_equal(trun.model.replica_broker.numpy(), tm.replica_broker.numpy())
    assert on_dead_disks(trun.model) == 0
    assert not (trun.model.replica_disk == tm.replica_disk).all()
