"""The intra-broker disk path (``INTRA_BROKER_GOAL_ORDER``) on a 100-broker
JBOD cluster (100 brokers, 10 racks, 40 topics, 84 partitions per topic,
RF 3, seed 2026, 4 disks a broker, DISK capacities scaled so that the
fullest broker sits at 70 %, the first disk of brokers 0, 10, ..., 90 dead)
on the JAX package's default above 64 brokers, ``optimize(fused=True)`` —
the inter-goal pipeline — by the JAX package and by the port's plain path:
per goal the same packed slots, chunk records, ``pipelined`` and fused
group, per run the same cross-goal counts, and the same final placement;
no replica moved across brokers and none left on a dead disk.

The JAX programs run in a child process at XLA's default backend
optimization level, as the service runs them (see
tests/test_torch_mid_parity.py).  Marked ``slow``: minutes on the CPU."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_100_brokers_intra_disk_matches_the_jax_package():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CRUISE_")}
    env.update(XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_intra_disk_mid as t; t.check_100()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout + done.stderr


def check_100():
    import numpy as np

    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_tpu_torch.analyzer import optimizer as topt
    from tests.test_torch_pipeline import compare
    from tests.torch_port_helpers import (INTRA_GOALS, goal_rows, jbod_model, on_dead_disks,
                                          to_torch)

    spec = dict(num_brokers=100, num_racks=10, num_topics=40, mean_partitions_per_topic=84.0,
                replication_factor=3, distribution="exponential", seed=2026)
    jm = jbod_model(spec, dead=tuple(range(0, 100, 10)))
    tm = to_torch(jm)
    jrun = jopt.optimize(jm, INTRA_GOALS, fused=True, raise_on_hard_failure=False)
    trun = topt.optimize(tm, INTRA_GOALS, fused=True, raise_on_hard_failure=False,
                         device="cpu")
    assert goal_rows(trun) == goal_rows(jrun)
    compare(jrun, trun)
    assert trun.pipelined
    assert on_dead_disks(tm) > 0 and on_dead_disks(trun.model) == 0
    np.testing.assert_array_equal(trun.model.replica_broker.numpy(), tm.replica_broker.numpy())
    print([(g.name, g.steps, g.actions_applied, g.satisfied_before, g.satisfied_after,
            g.pipelined, g.fused_group) for g in trun.goal_results])
