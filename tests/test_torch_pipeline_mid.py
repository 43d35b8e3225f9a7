"""A 100-broker cluster (100 brokers, 10 racks, 40 topics, 84 partitions
per topic, RF 3, seed 2026) through the full 15-goal stack on the JAX
package's default above 64 brokers, ``optimize(fused=True)`` — the
inter-goal pipeline with auto-fusion allowed — by the JAX package and by
the port's plain path: per goal the same packed slots, chunk records,
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
def test_100_brokers_pipelined_matches_the_jax_package():
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_backend_optimization_level")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CRUISE_")}
    env.update(XLA_FLAGS=" ".join(flags), JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-c", "import jax; jax.config.update('jax_platforms', 'cpu'); "
         "import tests.test_torch_pipeline_mid as t; t.check_100()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert done.returncode == 0, done.stdout + done.stderr


def check_100():
    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
    from cruise_control_tpu.model.generator import generate_cluster as jax_generate
    from tests.test_torch_pipeline import compare
    from tests.torch_port_helpers import STACK, compare_per_goal, to_torch

    jm = jax_generate(JaxSpec(num_brokers=100, num_racks=10, num_topics=40,
                              mean_partitions_per_topic=84.0, replication_factor=3,
                              distribution="exponential", seed=2026))
    jrun, trun = compare_per_goal(jm, to_torch(jm), STACK)
    compare(jrun, trun)
    assert trun.pipelined
    print("overlapped", trun.goals_overlapped, "fused", trun.goals_fused)
    print([(g.name, g.steps, g.actions_applied, len(g.chunks or []), g.pipelined,
            g.fused_group, g.chunks_cross_goal, g.chunks_cross_wasted)
           for g in trun.goal_results])
