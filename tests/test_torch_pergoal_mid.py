"""A 100-broker cluster (100 brokers, 10 racks, 40 topics, 84 partitions
per topic, RF 3, seed 2026) through the full 15-goal stack on the
sequential per-goal path, ``optimize(fused=True, pipeline=False)`` — at
100 brokers the JAX package runs every goal through its chunked frontier
driver, compacting above its 64-broker floor — by the JAX package and by
the port's plain path: the same packed slots and chunk records per goal,
the same goals skipped by the satisfied-sweep, the same final placement.

The JAX programs run in a child process at XLA's default backend
optimization level, as the service runs them (see
tests/test_torch_mid_parity.py).  Marked ``slow``: minutes on the CPU."""

import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_100_brokers_per_goal_matches_the_jax_package():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CRUISE_")}
    env.update(XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_pergoal_mid as t; t.check_100()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout + done.stderr


def check_100():
    from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
    from cruise_control_tpu.model.generator import generate_cluster as jax_generate
    from tests.torch_port_helpers import STACK, compare_per_goal, to_torch

    jm = jax_generate(JaxSpec(num_brokers=100, num_racks=10, num_topics=40,
                              mean_partitions_per_topic=84.0, replication_factor=3,
                              distribution="exponential", seed=2026))
    _, trun = compare_per_goal(jm, to_torch(jm), STACK, pipeline=False)
    buckets = {c["bucket"] for g in trun.goal_results for c in (g.chunks or [])}
    print("buckets", sorted(buckets, key=str))
    print([(g.name, g.steps, g.actions_applied, len(g.chunks or []))
           for g in trun.goal_results])
