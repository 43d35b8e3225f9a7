"""The facade's default goal order (``DEFAULT_GOAL_ORDER``, 16 goals) with
the four topics of the most partitions designated for min leaders, on a
100-broker cluster (100 brokers, 10 racks, 40 topics, 84 partitions per
topic, RF 3, seed 2026) on the JAX package's default above 64 brokers,
``optimize(fused=True)`` — the inter-goal pipeline — by the JAX package and
by the port's plain path: per goal the same packed slots, chunk records,
``pipelined``, ``fused_group`` and cross-goal counts, per run the same
``goals_overlapped`` and ``goals_fused``, and the same final placement.

The JAX programs run in a child process at XLA's default backend
optimization level, as the service runs them (see
tests/test_torch_mid_parity.py).  Marked ``slow``: minutes on the CPU."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_100_brokers_default_order_matches_the_jax_package():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CRUISE_")}
    env.update(XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_goal_kinds_mid as t; t.check_100()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout + done.stderr


def check_100():
    import dataclasses

    import numpy as np

    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
    from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
    from cruise_control_tpu.model.generator import generate_cluster as jax_generate
    from cruise_control_tpu_torch.analyzer import optimizer as topt
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from tests.test_torch_pipeline import compare
    from tests.torch_port_helpers import DEFAULT_GOAL_ORDER, goal_rows, to_torch

    jm = jax_generate(JaxSpec(num_brokers=100, num_racks=10, num_topics=40,
                              mean_partitions_per_topic=84.0, replication_factor=3,
                              distribution="exponential", seed=2026))
    topics = np.asarray(jm.partition_topic)[np.asarray(jm.partition_valid)]
    counts = np.bincount(topics, minlength=jm.num_topics)
    top = tuple(int(t) for t in np.argsort(-counts, kind="stable")[:4])
    jcon = dataclasses.replace(JaxBC.default(), min_leader_topic_ids=top)
    tcon = dataclasses.replace(BalancingConstraint.default(), min_leader_topic_ids=top)
    jrun = jopt.optimize(jm, DEFAULT_GOAL_ORDER, constraint=jcon, fused=True,
                         raise_on_hard_failure=False)
    trun = topt.optimize(to_torch(jm), DEFAULT_GOAL_ORDER, constraint=tcon, fused=True,
                         raise_on_hard_failure=False, device="cpu")
    assert goal_rows(trun) == goal_rows(jrun)
    compare(jrun, trun)
    assert trun.pipelined
    print("designated", top, "partitions", counts[list(top)].tolist())
    print([(g.name, g.steps, g.actions_applied, g.satisfied_before, g.satisfied_after,
            g.pipelined, g.fused_group) for g in trun.goal_results])
